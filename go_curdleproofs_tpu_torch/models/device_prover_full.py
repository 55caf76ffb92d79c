"""The one-fetch device-resident curdleproofs prove (counterpart of
go_curdleproofs_tpu/models/device_prover_full.py).

The host-orchestrated prover (models/curdleproof.py `prove`) fetches after
every MSM call and runs the transcript and the Fr arithmetic on the host.
This module runs the whole of curdleproof.go:38-197 of the Go reference
(same-permutation and grand-product setup, the sigma protocol, both folding
arguments) as one chain of device work over a device STROBE transcript:

  * step 1 (absorb the instance, squeeze `as`) stays on the host: it
    depends on host data only;
  * every randomness draw happens on the host up front, in the reference's
    exact order (draws do not depend on the transcript), and is uploaded
    with the rest of the inputs (`_upload`);
  * all commitments (A, B, C, the sigma protocol's nonces, the folding
    cross-terms) are computed and absorbed on the device; challenges are
    squeezed on the device with rejection sampling (`_chain`);
  * D uses the Gsum/Hsum identity D = B - beta^-1*Gsum + alpha*Hsum, the
    same group element that the reference prover assembles with an n-MSM
    (grandproductargument.go:111-138), so the proof bytes are unchanged;
  * the reference prover's self-checks (grandproductargument.go:156-177)
    and its rejections of degenerate challenges run on the device and are
    read from the final fetch (the same failures, deferred to the end);
  * one fetch (`device_common.fetch`) brings back every proof point (as
    x||y byte rows that need no square root), every proof scalar, the
    sanity flag and the final transcript state.

Between `_upload` and the fetch, `_chain` makes no device-to-host copy, no
other synchronising call and no upload. Byte-identical to the host prover.

On a CUDA device the chain is one CUDA graph (`_ChainGraph`): the first
prove of a shape runs `_chain` eagerly, which fills the device constants'
caches; the second captures it over fixed input buffers; every prove from
the second on copies its inputs into those buffers and replays the graph,
one launch for the ~14,000 of the eager chain. The CPU runs `_chain`
eagerly every time, and so does a CUDA device inside `eager_chain()`. The
`chain` span counts `chain.replays` (1 when a replay served the prove, 0
when the chain ran eagerly) beside `chain.kernels` (on a replay, the
launches the graph holds, counted at its capture; `kernels.launches`
counts only what a wrapper launches); the spans inside the chain exist
only where `_chain` runs (eagerly, or once as it is captured).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from ..ops import compress_dev, curve, fr, halflimb, kernels, strobe_dev
from ..ops.curve import PointVec
from ..utils import field_host as fh
from ..utils import profiling
from ..utils.field_host import Affine
from ..utils.rand import Rand
from ..utils.transcript import Transcript
from . import device_prover2 as dp2
from .device_common import (append_points_dev, append_scalars_dev,
                            challenge_fr, enqueue, fetch, fr_bytes_be,
                            fr_const, fr_digits, lane_index, point_at,
                            point_rows, points_equal, scalar_of, scalar_rows,
                            stack_points, sync_host_transcript, take_points,
                            transcript_to_device)

N_BLINDERS = 4

# transcript labels (the host modules' and the Go reference's, byte for byte)
SP_STEP1 = b"same_perm_step1"
SP_ALPHA = b"same_perm_alpha"
SP_BETA = b"same_perm_beta"
GP_STEP1 = b"gprod_step1"
GP_STEP2 = b"gprod_step2"
GP_ALPHA = b"gprod_alpha"
GP_BETA = b"gprod_beta"
SS_POINTS = b"sameexp_points"
SS_ALPHA = b"sameexp_alpha"

# Uploaded points that outlive one prove, keyed by content and device (the
# point tuples themselves are the keys, so a freed object can never alias a
# live entry): the CRS's [gt, gu, h, gsum, hsum] and the last [Rs, Ss] pair
# with its multiples table.
_crs_points_cache: Dict[tuple, PointVec] = {}
_rs_cache: Dict[tuple, curve.StackedVec] = {}
_CACHE_MAX = 4


def _crs_points(crs, device: torch.device) -> PointVec:
    key = (crs.gt, crs.gu, crs.h, crs.gsum, crs.hsum, device)
    pts = _crs_points_cache.get(key)
    if pts is None:
        if len(_crs_points_cache) >= _CACHE_MAX:
            _crs_points_cache.clear()
        pts = curve.from_affine_host(list(key[:5]), device=device)
        _crs_points_cache[key] = pts
    return pts


def _rs_stacked(Rs, Ss, n: int, device: torch.device) -> curve.StackedVec:
    key = (tuple(Rs), tuple(Ss), n, device)
    sv = _rs_cache.get(key)
    if sv is None:
        sv = curve.StackedVec.from_affine([Rs, Ss], device=device, pad_to=n)
        _rs_cache.clear()               # bound the cache to the live pair
        _rs_cache[key] = sv
    return sv


def _tree_prod(v: torch.Tensor) -> torch.Tensor:
    """Product of all lanes of [m, 8], m a power of two, as a log-depth
    tree; a [1, 8] result."""
    while v.shape[0] > 1:
        half = v.shape[0] // 2
        v = fr.mul(v[:half], v[half:])
    return v


def _inner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fr.inner_product(a, b)[None]


# ---------------------------------------------------------------------------
# device pieces


def _piece_sameperm(ts, table, digA, m_bytes, as_rows, perm_v, perm_as_v,
                    rs_m_v, rs_ap_v, M_gsum, ell: int):
    """Commit A; same-permutation step 1 and its challenges; bs, p, B, rs_b
    (samepermutationargument.go:32-78)."""
    n = perm_v.shape[0]
    A = curve.msm_rows_points_from_table(table, digA[None], (0,))   # [1]
    append_points_dev(ts, SP_STEP1, A)
    ts.append_rows(SP_STEP1, m_bytes)
    ts.append_rows(SP_STEP1, as_rows)
    alpha = challenge_fr(ts, SP_ALPHA)
    beta = challenge_fr(ts, SP_BETA)

    # bs[i] = alpha*perm[i] + as[perm[i]] + beta on the first ell lanes;
    # dead lanes hold 1 (so the product tree ignores them)
    live = (lane_index(n, perm_v.device) < ell)[:, None]
    bs = fr.add(fr.add(fr.mul(perm_v, alpha), perm_as_v), beta)
    bs = torch.where(live, bs, fr.constant(1, (1,), device=bs.device))
    p = _tree_prod(bs)

    # B = A + alpha*M + beta*gsum (samepermutationargument.go:74-78)
    terms = curve.scalar_mul_steps(
        M_gsum, fr_digits(torch.cat([alpha, beta])))
    B = curve.add(A, curve.add(point_at(terms, 0), point_at(terms, 1)))
    rs_b = fr.add(fr.mul(rs_m_v, alpha), rs_ap_v)
    return A, B, bs, p, rs_b


def _piece_gpa1(ts, table, B, bs, p, rs_b, r_cs_pad, ell: int):
    """Grand-product steps 1-2: absorb B, p; alpha; partial products cs;
    C = <cs ++ r_cs, [Gs|Hs]>; r_p; absorb C, r_p; beta
    (grandproductargument.go:42-93)."""
    n = bs.shape[0]
    append_points_dev(ts, GP_STEP1, B)
    append_scalars_dev(ts, GP_STEP1, p)
    alpha = challenge_fr(ts, GP_ALPHA)

    # cs[0] = 1, cs[i] = prod bs[:i] over live lanes (dead bs lanes are 1)
    live = (lane_index(n, bs.device) < ell)[:, None]
    cs_full = torch.where(live, fr.prefix_products(bs), r_cs_pad)
    C = curve.msm_rows_points_from_table(table, fr_digits(cs_full)[None],
                                         (0,))                      # [1]
    r_b_plus_alpha = fr.add(rs_b, alpha)
    r_p = _inner(r_b_plus_alpha, cs_full[ell:ell + 4])

    append_points_dev(ts, GP_STEP2, C)
    append_scalars_dev(ts, GP_STEP2, r_p)
    beta = challenge_fr(ts, GP_BETA)
    return C, cs_full, r_b_plus_alpha, r_p, alpha, beta


def _piece_gpa2(table, B, C, Gsum_Hsum, bs, cs_full, r_b_plus_alpha, r_p, p,
                alpha, beta, binv, ell: int):
    """Grand-product step 3: diag, ds_full, z; D via the Gsum/Hsum
    identity; the prover's self-checks (grandproductargument.go:94-177,
    value-identical)."""
    n = cs_full.shape[0]
    live = (lane_index(n, bs.device) < ell)[:, None]
    pw = fr.prefix_products(beta.expand(n + 2, -1).contiguous())   # beta^i
    bpw = fr.prefix_products(binv.expand(n + 2, -1).contiguous())  # beta^-i
    b_l, b_l1 = pw[ell:ell + 1], pw[ell + 1:ell + 2]
    diag = torch.where(live, bpw[1:n + 1], bpw[ell + 1])

    # ds[i] = bs[i]*beta^(i+1) - beta^i (i < ell); blinder lanes:
    # beta^(l+1) * (r_b + alpha)
    ds = fr.sub(fr.mul(bs, pw[1:n + 1].contiguous()), pw[:n])
    blind = torch.zeros_like(ds)
    blind[ell:ell + 4] = fr.mul(r_b_plus_alpha, b_l1)
    ds_full = torch.where(live, ds, blind)

    # z = r_p*beta^(l+1) + p*beta^l - 1  (grandproductargument.go:147-155)
    z = fr.sub(fr.add(fr.mul(r_p, b_l1), fr.mul(p, b_l)),
               fr.constant(1, (1,), device=p.device))

    # D = B - binv*Gsum + alpha*Hsum (grandproductargument.go:111-138 via
    # the verifier's Gsum/Hsum identity: the same group element)
    terms = curve.scalar_mul_steps(
        Gsum_Hsum, fr_digits(torch.cat([binv, alpha])))
    D = curve.add(B, curve.add(curve.neg(point_at(terms, 0)),
                               point_at(terms, 1)))

    # deferred prover self-checks (grandproductargument.go:156-177)
    chk1 = fr.is_zero(fr.sub(_inner(cs_full, ds_full), z))
    sc2 = curve.msm_rows_points_from_table(
        table, fr_digits(fr.mul(ds_full, diag))[None], (0,))
    sane = chk1 & points_equal(sc2, D)
    return stack_points([C, D]), z, ds_full, diag, sane


def _piece_blind1(rs_v, zs_pad, cs_full, ds_full):
    """Blinder solve, part 1: omega and the cs[n-2] lane that feeds the
    first inversion (innerproductargument.go:299-355)."""
    n = cs_full.shape[0]
    ips = fr.inner_product(torch.stack([rs_v, zs_pad]),
                           torch.stack([ds_full, cs_full]))
    return fr.add(ips[0:1], ips[1:2]), cs_full[n - 2:n - 1]


def _piece_blind2(rs_v, cs_full, omega, inv_c, delta):
    """term1 and term2 of the 2x2 solve
    (innerproductargument.go:356-371)."""
    n = cs_full.shape[0]
    c_last = cs_full[n - 1:n]
    ric = fr.mul(rs_v[n - 2:n - 1], inv_c)
    term1 = fr.sub(fr.mul(ric, omega), delta)
    term2 = fr.sub(rs_v[n - 1:n], fr.mul(ric, c_last))
    return term1, term2, ~fr.is_zero(term2), c_last


def _piece_blind3(zs_pad, term1, term2_inv, inv_c, c_last, omega, rs_v,
                  ds_full, cs_full):
    """Finish the solve: last_z, penultimate_z, the full rs_d; verify both
    blinder constraints (deferred; innerproductargument.go:372-391)."""
    n = zs_pad.shape[0]
    last_z = fr.mul(term1, term2_inv)
    pen_z = fr.mul(fr.neg(inv_c), fr.add(fr.mul(last_z, c_last), omega))
    rs_d = zs_pad.clone()
    rs_d[n - 2] = pen_z[0]
    rs_d[n - 1] = last_z[0]
    ips = fr.inner_product(torch.stack([rs_v, rs_d, rs_v]),
                           torch.stack([ds_full, cs_full, rs_d]))
    c1 = fr.is_zero(fr.add(ips[0:1], ips[1:2]))
    c2 = fr.is_zero(ips[2:3])
    return rs_d, c1 & c2


def _piece_sigma(ts, RS, A, base_pts, dig12, k_v, r_t_v, r_u_v, r_a_v, r_b_v,
                 r_k_v):
    """Group commitments T, U, the whole sigma protocol and a_prime
    (curdleproof.go:116-143, samescalarargument.go:34-81). One 12-lane
    scalar multiplication covers every commitment leg."""
    gt, gu, h = (point_at(base_pts, i) for i in range(3))
    R, S = point_at(RS, 0), point_at(RS, 1)
    lanes = stack_points([gt, gu, R, S, h, h, gt, gu, R, S, h, h])
    out = curve.scalar_mul_steps(lanes, dig12)
    t1_t, t1_u = point_at(out, 0), point_at(out, 1)
    # t2 = k*[R, S] + [r_t, r_u]*h ; a2, b2 = r_k*[R, S] + [r_a, r_b]*h
    sums = curve.add(take_points(out, (2, 3, 8, 9)),
                     take_points(out, (4, 5, 10, 11)))
    t2_t, t2_u, a2, b2 = (point_at(sums, i) for i in range(4))
    a1, b1 = point_at(out, 6), point_at(out, 7)

    ten = stack_points([R, S, t1_t, t2_t, t1_u, t2_u, a1, a2, b1, b2])
    append_points_dev(ts, SS_POINTS, ten)
    alpha = challenge_fr(ts, SS_ALPHA)

    z = fr.add(torch.cat([r_k_v, r_a_v, r_b_v]),
               fr.mul(torch.cat([k_v, r_t_v, r_u_v]), alpha))   # z_k z_t z_u
    a_prime = curve.add(A, curve.add(t1_t, t1_u))
    cm_pts = stack_points([t1_t, t2_t, t1_u, t2_u, a1, a2, b1, b2])
    azz = stack_points([a_prime, t2_t, t2_u])
    return cm_pts, azz, z


def _piece_finalize(pt_parts, scalars, gammas, sanity):
    """Compress every proof point (x||y rows), canonicalise the proof
    scalars, evaluate the deferred sanity flags: what the one fetch
    carries."""
    rows = compress_dev.compress_xy(stack_points(list(pt_parts)))
    sc_be = fr_bytes_be(torch.cat(list(scalars)))
    gamma_ok = ~fr.is_zero(torch.cat(list(gammas))).any()
    sane = torch.cat(list(sanity)).all() & gamma_ok
    return rows, sc_be, sane[None]


# ---------------------------------------------------------------------------


@dataclass
class _Inputs:
    """Everything `_chain` reads, on the device."""
    ell: int
    ts: strobe_dev.TState
    table: PointVec              # [9, 1, 2n] of the one row [Gs|Hs]
    table_rs: PointVec           # [9, 2, 2n] of [Rs, Ss]
    table_sm: PointVec           # [9, 3, 2n] of [G, T', U']
    base_pts: PointVec           # gt, gu, h
    Gsum_Hsum: PointVec
    M_gsum: PointVec
    digA: torch.Tensor
    dig_rs: torch.Tensor
    dig12: torch.Tensor
    m_bytes: torch.Tensor
    as_rows: torch.Tensor
    tu_bytes: torch.Tensor
    scalars: Dict[str, torch.Tensor]  # the uploaded Fr vectors, by name


def _upload(crs, Rs, Ss, Ts, Us, M, perm, k, rs_m, draws, as_,
            transcript: Transcript, device: torch.device) -> _Inputs:
    from . import curdleproof, same_permutation

    ell = len(Rs)
    n = ell + N_BLINDERS
    perm_as = same_permutation.permute(as_, perm)
    rs_a_prime = draws["rs_a"] + [0, 0]
    r_t, r_u, r_a, r_b, r_k = (draws[name] for name in
                               ("r_t", "r_u", "r_a", "r_b", "r_k"))
    rs_blind, zs_blind = draws["rs_blind"], draws["zs_blind"]

    # one device row [Gs|Hs] and its table per CRS, device and process,
    # shared with shuffle_permute_commit and the verifier
    table = curdleproof._gh_stacked(crs.gs, crs.hs, device).table()
    crs_pts = _crs_points(crs, device)
    G = list(crs.gs) + list(crs.hs[: N_BLINDERS - 2]) + [crs.gt, crs.gu]
    T_prime = list(Ts) + [None, None, crs.h, None]
    U_prime = list(Us) + [None, None, None, crs.h]
    x = perm_as + draws["rs_a"] + [r_t, r_u]
    sm_sv = curve.StackedVec.from_affine([G, T_prime, U_prime],
                                         device=device, pad_to=n)
    frs = dict(
        perm=list(perm) + [0] * (n - ell), perm_as=perm_as + [0] * (n - ell),
        rs_m=rs_m, rs_ap=rs_a_prime, r_cs_pad=[0] * ell + draws["r_cs"],
        rs_v=rs_blind, zs_pad=zs_blind + [0, 0],
        delta=[fh.fr_inner_product(rs_blind[:n - 2], zs_blind)],
        ones=[1] * n, k=[k], r_t=[r_t], r_u=[r_u], r_a=[r_a], r_b=[r_b],
        r_k=[r_k], r_sm=draws["r_sm"], x=x)
    dig = lambda sc: curve._digits(curve.scalars_to_digits(sc), device)
    dig_as = dig(as_ + [0] * (n - ell))
    return _Inputs(
        ell=ell, ts=transcript_to_device(transcript, device), table=table,
        table_rs=_rs_stacked(Rs, Ss, n, device).table(),
        table_sm=sm_sv.table(),
        base_pts=curve.pmap(lambda t: t[:3], crs_pts),
        Gsum_Hsum=curve.pmap(lambda t: t[3:5], crs_pts),
        M_gsum=curve.from_affine_host([M, crs.gsum], device=device),
        digA=dig(perm_as + rs_a_prime),
        dig_rs=torch.stack([dig_as, dig_as]),
        dig12=dig([r_t, r_u, k, k, r_t, r_u, r_a, r_b, r_k, r_k, r_a, r_b]),
        m_bytes=strobe_dev.bytes_tensor(point_rows([M]), device),
        as_rows=strobe_dev.bytes_tensor(scalar_rows(as_), device),
        tu_bytes=strobe_dev.bytes_tensor(point_rows(T_prime + U_prime),
                                          device),
        scalars={name: fr_const(vals, device)
                 for name, vals in frs.items()})


def _chain(inp: _Inputs) -> List[torch.Tensor]:
    """The whole prove as device work, from the uploaded inputs to the
    tensors of the one fetch. No device-to-host copy, no synchronising
    call."""
    ell, ts, table, f = inp.ell, inp.ts, inp.table, inp.scalars
    n = ell + N_BLINDERS

    with profiling.span("sameperm_gpa"):
        A, B, bs, p, rs_b = _piece_sameperm(
            ts, table, inp.digA, inp.m_bytes, inp.as_rows, f["perm"],
            f["perm_as"], f["rs_m"], f["rs_ap"], inp.M_gsum, ell)
        C, cs_full, r_b_plus_alpha, r_p, gp_alpha, gp_beta = _piece_gpa1(
            ts, table, B, bs, p, rs_b, f["r_cs_pad"], ell)
        binv = dp2._gamma_inv(gp_beta)
        CD, z, ds_full, diag, sane_gpa = _piece_gpa2(
            table, B, C, inp.Gsum_Hsum, bs, cs_full, r_b_plus_alpha, r_p, p,
            gp_alpha, gp_beta, binv, ell)

    with profiling.span("blinders"):
        rs_v, zs_pad = f["rs_v"], f["zs_pad"]
        omega, c_pen = _piece_blind1(rs_v, zs_pad, cs_full, ds_full)
        inv_c = dp2._gamma_inv(c_pen)
        term1, term2, blind_nz, c_last = _piece_blind2(
            rs_v, cs_full, omega, inv_c, f["delta"])
        rs_d, sane_blind = _piece_blind3(
            zs_pad, term1, dp2._gamma_inv(term2), inv_c, c_last, omega, rs_v,
            ds_full, cs_full)

    # inner-product argument over the one row [Gs|Hs], Gs' lazy by diag
    with profiling.span("ipa"):
        bcd, hcur, csd, dsd = dp2._ipa_setup(
            table, f["ones"], diag, rs_v, rs_d, ts, CD, z, cs_full, ds_full,
            point_at(inp.base_pts, 2))
        ipa_blobs, ipa_gammas, csd, dsd = dp2.run_ipa_rounds(
            ts, table, hcur, f["ones"], diag, csd, dsd, n)

    # step 3 and the sigma protocol: R = <as, Rs>, S = <as, Ss>
    with profiling.span("step3_sigma"):
        RS = curve.msm_rows_points_from_table(inp.table_rs, inp.dig_rs,
                                              (0, 1))
        cm_pts, azz, z_kzu = _piece_sigma(
            ts, RS, A, inp.base_pts, inp.dig12, f["k"], f["r_t"], f["r_u"],
            f["r_a"], f["r_b"], f["r_k"])

    with profiling.span("samemsm"):
        b_atu, xd = dp2._sm_setup(inp.table_sm, f["r_sm"], ts, azz,
                                  inp.tu_bytes, f["x"])
        sm_blobs, sm_gammas, xd = dp2.run_sm_rounds(ts, inp.table_sm,
                                                    f["ones"], xd, n)

    with profiling.span("finalize"):
        rows, sc_be, sane = _piece_finalize(
            (A, B, C, RS, cm_pts, bcd, b_atu), (r_p, z_kzu),
            ipa_gammas + sm_gammas + [gp_beta],
            (sane_gpa, sane_blind, blind_nz))
        return ([rows, sc_be, sane, fr_bytes_be(csd[:1]),
                 fr_bytes_be(dsd[:1]), fr_bytes_be(xd[:1]), ts.st]
                + ipa_blobs + sm_blobs)


def _remap(inp: _Inputs, fn) -> _Inputs:
    """`inp` with fn applied to every tensor that `_chain` reads (a new
    TState at the same positions)."""
    def one(v):
        if isinstance(v, torch.Tensor):
            return fn(v)
        if isinstance(v, PointVec):
            return curve.pmap(fn, v)
        if isinstance(v, dict):
            return {k: fn(t) for k, t in v.items()}
        if isinstance(v, strobe_dev.TState):
            return strobe_dev.TState(fn(v.st), v.pos, v.pos_begin)
        return v
    return _Inputs(**{f.name: one(getattr(inp, f.name))
                      for f in dataclasses.fields(inp)})


def _tensors(inp: _Inputs) -> List[torch.Tensor]:
    """Every tensor that `_chain` reads, in one fixed order."""
    out: List[torch.Tensor] = []

    def keep(t):
        out.append(t)
        return t

    _remap(inp, keep)
    return out


class _ChainGraph:
    """`_chain` of one shape on one CUDA device as a CUDA graph.

    `capture` copies a prove's inputs into buffers of its own, captures
    `_chain` over them (the hand-written launchers enqueue on torch's
    current stream, which is the capture stream) and keeps what the graph
    reads: the input buffers, the output tensors, every device constant
    the chain took from a `halflimb.device_cache` (held whatever the caches
    evict), the launches of each kernel it holds and the transcript
    positions it ends at, which depend on the shape and the labels alone.
    It then replays once, for the prove whose inputs it copied (a capture
    runs nothing). Where the chain meets a device constant that its cache
    no longer holds, the upload raises `halflimb.UploadInCapture`: the
    capture keeps nothing, takes back the launches it counted and returns
    False, and the prove runs the chain eagerly, which uploads the
    constant again for the next capture. `replay` copies a later prove's
    inputs in and replays; it calls no wrapper, so `kernels.launches`
    stays as it was. `lock` is held from the copy-in to the end of the
    fetch, so that two proves never share the buffers."""

    def __init__(self):
        self.lock = threading.Lock()
        self.warm = False               # an eager prove has run
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def capture(self, inp: _Inputs) -> bool:
        inputs = _remap(inp, torch.clone)
        # taken before the chain, which moves `inputs.ts.st` on
        buffers = _tensors(inputs)
        before = dict(kernels.launches)
        graph = torch.cuda.CUDAGraph()
        try:
            with halflimb.holding() as consts, torch.cuda.graph(graph):
                outputs = _chain(inputs)
        except halflimb.UploadInCapture:
            kernels.launches.update(before)
            return False
        self.buffers, self.consts, self.outputs = buffers, consts, outputs
        self.launches = {k: n - before[k]
                         for k, n in kernels.launches.items()}
        self.end = (inputs.ts.pos, inputs.ts.pos_begin)
        self.graph = graph
        graph.replay()
        return True

    def replay(self, inp: _Inputs) -> None:
        for buf, t in zip(self.buffers, _tensors(inp)):
            buf.copy_(t)
        self.graph.replay()


_graphs: Dict[tuple, _ChainGraph] = {}
_graphs_lock = threading.Lock()
_eager_blocks = 0                       # open `eager_chain()` blocks


@contextlib.contextmanager
def eager_chain():
    """A block in which every device prove runs its chain eagerly, for
    tools that wrap the chain's pieces or the kernels' wrappers: a replay
    of the graph calls neither."""
    global _eager_blocks
    _eager_blocks += 1
    try:
        yield
    finally:
        _eager_blocks -= 1


def _graph_entry(inp: _Inputs) -> Optional[_ChainGraph]:
    """The graph entry of the prove's shape and device, made on first use;
    None off CUDA, where the chain always runs eagerly, and inside an
    `eager_chain()` block."""
    if inp.ts.st.device.type != "cuda" or _eager_blocks:
        return None
    key = (inp.ts.st.device, inp.ell, inp.ts.pos, inp.ts.pos_begin,
           tuple((tuple(t.shape), t.dtype) for t in _tensors(inp)))
    with _graphs_lock:
        return _graphs.setdefault(key, _ChainGraph())


def _eager(inp: _Inputs) -> List[torch.Tensor]:
    profiling.count("chain.replays", 0)
    return _chain(inp)


def _graphed(entry: _ChainGraph, inp: _Inputs) -> List[torch.Tensor]:
    """The chain by the entry's graph, captured over this prove's inputs if
    it has none yet; eagerly where the capture fails."""
    if entry.graph is not None:
        entry.replay(inp)
        # the launches the graph holds, counted as it was captured
        profiling.count("chain.kernels", sum(entry.launches.values()))
    elif not entry.capture(inp):
        return _eager(inp)
    profiling.count("chain.replays", 1)
    inp.ts.pos, inp.ts.pos_begin = entry.end
    return entry.outputs


def _run_chain(inp: _Inputs) -> List:
    """The chain and its one fetch: eagerly on the CPU and on a shape's
    first prove on a CUDA device, by the shape's graph after that."""
    entry = _graph_entry(inp)
    if entry is None:
        return fetch(enqueue(_eager, inp))
    with entry.lock:
        if entry.warm:
            return fetch(enqueue(_graphed, entry, inp))
        entry.warm = True
        return fetch(enqueue(_eager, inp))


@profiling.traced("device_prove")
def prove_on_device(crs, Rs: List[Affine], Ss: List[Affine],
                    Ts: List[Affine], Us: List[Affine], M: Affine,
                    perm: Sequence[int], k: int, rs_m: List[int],
                    rand: Rand, *, device: torch.device):
    """Drop-in replacement for curdleproof.prove: byte-identical proof, one
    device fetch (curdleproof.go:38-197)."""
    from . import curdleproof, grand_product, group_commitment
    from . import inner_product, same_multiscalar, same_permutation
    from . import same_scalar

    ell = len(Rs)
    n = ell + N_BLINDERS
    rounds = n.bit_length() - 1
    if n & (n - 1):
        raise ValueError("ell + 4 must be a power of two")

    # host: the step-1 transcript, then ALL randomness draws in the
    # reference's order (curdleproof.go:60, grandproductargument.go:66,
    # innerproductargument.go:304-305, curdleproof.go:104-106,
    # samescalarargument.go:39-41, samemultiscalarargument.go:55)
    transcript = Transcript(curdleproof.LABEL_TRANSCRIPT)
    transcript.append_points(curdleproof.LABEL_STEP1, *Rs)
    transcript.append_points(curdleproof.LABEL_STEP1, *Ss)
    transcript.append_points(curdleproof.LABEL_STEP1, *Ts)
    transcript.append_points(curdleproof.LABEL_STEP1, *Us)
    transcript.append_points(curdleproof.LABEL_STEP1, M)
    as_ = transcript.get_and_append_challenges(curdleproof.LABEL_VEC_A, ell)

    with profiling.span("draws"):
        draws = dict(rs_a=rand.get_frs(N_BLINDERS - 2),
                     r_cs=rand.get_frs(N_BLINDERS),
                     rs_blind=rand.get_frs(n), zs_blind=rand.get_frs(n - 2))
        for name in ("r_t", "r_u", "r_a", "r_b", "r_k"):
            draws[name] = rand.get_fr()
        draws["r_sm"] = rand.get_frs(n)

    with profiling.span("upload"):
        inp = _upload(crs, Rs, Ss, Ts, Us, M, perm, k, rs_m, draws, as_,
                      transcript, device)
    rows_h, sc_h, sane_h, c0h, d0h, x0h, sstate, *blobs_h = _run_chain(inp)

    if not bool(sane_h[0]):
        raise ValueError(
            "device prover sanity check failed (degenerate challenge or "
            "prover self-check mismatch)")

    with profiling.span("assemble"):
        pt = compress_dev.decode_xy_host
        A_h, B_h, C_h, R_h, S_h = (pt(rows_h[i]) for i in range(5))
        cm = rows_h[5:13]
        bc_h, bd_h = pt(rows_h[13]), pt(rows_h[14])
        ba_h, bt_h, bu_h = (pt(rows_h[i]) for i in (15, 16, 17))
        r_p_h, z_k_h, z_t_h, z_u_h = (scalar_of(sc_h[i]) for i in range(4))

        ipa_h, sm_h = blobs_h[:rounds], blobs_h[rounds:]
        ipa_proof = inner_product.Proof(
            b_c=bc_h, b_d=bd_h,
            l_cs=[pt(ipa_h[r][0]) for r in range(rounds)],
            r_cs=[pt(ipa_h[r][2]) for r in range(rounds)],
            l_ds=[pt(ipa_h[r][1]) for r in range(rounds)],
            r_ds=[pt(ipa_h[r][3]) for r in range(rounds)],
            c0=scalar_of(c0h[0]), d0=scalar_of(d0h[0]))
        gpa_proof = grand_product.Proof(C_h, r_p_h, ipa_proof)
        sp_proof = same_permutation.Proof(B_h, gpa_proof)

        cm_t = group_commitment.GroupCommitment(pt(cm[0]), pt(cm[1]))
        cm_u = group_commitment.GroupCommitment(pt(cm[2]), pt(cm[3]))
        ss_proof = same_scalar.Proof(
            group_commitment.GroupCommitment(pt(cm[4]), pt(cm[5])),
            group_commitment.GroupCommitment(pt(cm[6]), pt(cm[7])),
            z_k_h, z_t_h, z_u_h)

        sm_proof = same_multiscalar.Proof(
            b_a=ba_h, b_t=bt_h, b_u=bu_h,
            l_a=[pt(sm_h[r][0]) for r in range(rounds)],
            l_t=[pt(sm_h[r][1]) for r in range(rounds)],
            l_u=[pt(sm_h[r][2]) for r in range(rounds)],
            r_a=[pt(sm_h[r][3]) for r in range(rounds)],
            r_t=[pt(sm_h[r][4]) for r in range(rounds)],
            r_u=[pt(sm_h[r][5]) for r in range(rounds)],
            x=scalar_of(x0h[0]))

        sync_host_transcript(transcript, sstate, inp.ts.pos,
                             inp.ts.pos_begin)
        return curdleproof.Proof(A_h, cm_t, cm_u, R_h, S_h, sp_proof,
                                 ss_proof, sm_proof)
