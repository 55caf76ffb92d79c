"""Device-resident folding provers with lazy base folding (counterpart of
go_curdleproofs_tpu/models/device_prover2.py).

Mirrors innerproductargument.go:42-188 and samemultiscalarargument.go:37-157
of the Go reference byte for byte (transcript, draw order, proof bytes),
restructured for a device:

  * the bases and their multiples table live on the device and are built
    once per argument. The reference folds the bases every round
    (G' = G_lo + gamma*G_hi). Since <v, G_r> = <lift(v), G_0>, every fold
    instead becomes O(n) Fr lane algebra on the device: a per-lane
    gamma-weight vector W (W[i0] takes in gamma_j for every fold bit set in
    i0) and the folded scalar vectors kept in replicated form
    (CS[i0] = cs_r[i0 mod n_r]). No per-round point work besides the
    cross-term MSMs themselves;
  * everything a round carries (the STROBE transcript state, the weight and
    scalar vectors) stays on the device; the host only enqueues work, so
    the rounds stream through the device queue with no host round trip.
    The challenge is squeezed, tested against r and re-absorbed on the
    device (`strobe_challenge32`), gamma^-1 is the Fr ladder kernel
    (`fr_pow_fixed`), the window digits of the folded scalars are recoded
    on the device (ops/glv_dev.py);
  * the cross-term MSMs are `msm_select_reduce` + `windowed_combine`; the
    two-point H-term multiplication of an IPA round is the window loop
    `curve.scalar_mul_steps` on `point_x16_add`.

One fetch at the very end brings back the proof bytes and the transcript
state.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..ops import compress_dev, curve, fr, strobe_dev
from ..ops.curve import PointVec
from ..utils import profiling
from ..utils.field_host import Affine
from ..utils.rand import Rand
from ..utils.transcript import Transcript
from .device_common import (LABEL_ALPHA, LABEL_BETA, LABEL_GAMMA, LABEL_LOOP,
                            LABEL_STEP1, SM_LABEL_ALPHA, SM_LABEL_GAMMA,
                            SM_LABEL_LOOP, SM_LABEL_STEP1,
                            append_points_dev, append_scalars_dev,
                            challenge_fr, challenge_to_fr, enqueue, fetch,
                            fr_bytes_be, fr_const, fr_digits, fr_scalar,
                            lane_index, masked_inner, point_at, point_rows,
                            roll_fr, scalar_of, stack_points,
                            sync_host_transcript, transcript_to_device)


def _fold_bit(n: int, blog: int, device: torch.device) -> torch.Tensor:
    """Bit `blog` of each level-0 lane index: the fold's block selector."""
    return (lane_index(n, device) >> blog) & 1


def _lo_rep(v: torch.Tensor, bit: torch.Tensor, half: int) -> torch.Tensor:
    """Replicated-low view: out[i0] = v_r[i0 mod half] (v replicated at
    period 2*half -> out replicated at period half)."""
    return torch.where((bit == 1)[:, None], roll_fr(v, half), v)


def _hi_rep(v: torch.Tensor, bit: torch.Tensor, half: int) -> torch.Tensor:
    """Replicated-high view: out[i0] = v_r[(i0 mod half) + half]."""
    return torch.where((bit == 0)[:, None], roll_fr(v, -half), v)


def _gamma_inv(gamma: torch.Tensor) -> torch.Tensor:
    """gamma^-1 = gamma^(r-2) as one launch of the Fr ladder kernel."""
    return fr.inv(gamma)


def _gamma_or_one(bit: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """gamma on the lanes whose fold bit is set, 1 elsewhere."""
    one = fr.constant(1, (1,), device=gamma.device)
    return torch.where((bit == 1)[:, None], gamma, one)


# ---------------------------------------------------------------------------
# IPA pieces


def _ipa_setup(table: PointVec, rows: Sequence[int], Wg0, Wgp0, rs_c, rs_d,
               ts: strobe_dev.TState, CD: PointVec, z, cs, ds, hpt: PointVec):
    """Blinder commitments, the step-1 absorb, alpha and beta, the scalar
    blend and H' = beta*H (innerproductargument.go:60-91)."""
    dig = fr_digits(fr.mul(torch.stack([Wg0, Wgp0]),
                           torch.stack([rs_c, rs_d])))          # [2, 2n, W]
    bcd = curve.msm_rows_points_from_table(table, dig, rows[:2])
    append_points_dev(ts, LABEL_STEP1, CD)
    append_scalars_dev(ts, LABEL_STEP1, z)
    append_points_dev(ts, LABEL_STEP1, bcd)
    alpha = challenge_fr(ts, LABEL_ALPHA)
    beta = challenge_fr(ts, LABEL_BETA)
    blend = fr.add(torch.stack([rs_c, rs_d]),
                   fr.mul(torch.stack([cs, ds]), alpha))
    hcur = curve.scalar_mul_steps(hpt, fr_digits(beta))
    return bcd, hcur, blend[0], blend[1]


def _ipa_round_cross(table: PointVec, rows: Sequence[int], hcur: PointVec,
                     Wg, Wgp, CS, DS, half: int, blog: int) -> PointVec:
    """The round's 4 cross-terms L_C, L_D, R_C, R_D as lifted level-0 MSMs
    against the fixed table, plus the <c_L,d_R> and <c_R,d_L> H-terms
    (innerproductargument.go:100-147)."""
    n = CS.shape[0]
    bit = _fold_bit(n, blog, CS.device)
    cl, cr = _lo_rep(CS, bit, half), _hi_rep(CS, bit, half)
    dl, dr = _lo_rep(DS, bit, half), _hi_rep(DS, bit, half)
    hi = bit == 1
    # L_C: <c_L, G_R>, L_D: <d_R, G'_L>, R_C: <c_R, G_L>, R_D: <d_L, G'_R>
    lifted = fr.mul(torch.stack([Wg, Wgp, Wg, Wgp]),
                    torch.stack([cl, dr, cr, dl]))
    keep = torch.stack([hi, ~hi, ~hi, hi])[..., None]
    outs = curve.msm_rows_points_from_table(
        table, fr_digits(torch.where(keep, lifted, 0)), rows)       # [4]

    ips = masked_inner(torch.stack([cl, cr]), torch.stack([dr, dl]), half)
    h_terms = curve.scalar_mul_steps(stack_points([hcur, hcur]),
                                     fr_digits(ips))                # [2]
    l_c = curve.add(point_at(outs, 0), point_at(h_terms, 0))
    r_c = curve.add(point_at(outs, 2), point_at(h_terms, 1))
    return stack_points([l_c, point_at(outs, 1), r_c, point_at(outs, 3)])


def _round_absorb(ts: strobe_dev.TState, lr_pts: PointVec, label: bytes,
                  chal_label: bytes) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compress and absorb the round's cross terms, squeeze gamma. Returns
    the 96-byte compress_xy rows (compressed form + affine y, so the host
    assembles proof points without square roots; only the first 48 bytes
    enter the transcript) and gamma."""
    blobs = compress_dev.compress_xy(lr_pts)                    # [k, 96]
    ts.append_rows(label, blobs[:, :48].contiguous())
    return blobs, challenge_to_fr(ts.get_and_append_challenge(chal_label))


def _ipa_round_update(Wg, Wgp, CS, DS, gamma, ginv, half: int, blog: int):
    """Lazy fold: the weight vectors take in gamma on the high-bit lanes,
    the replicated scalar vectors fold in place. Fr lane algebra only."""
    n = CS.shape[0]
    bit = _fold_bit(n, blog, CS.device)
    W = fr.mul(torch.stack([Wg, Wgp]),
               torch.stack([_gamma_or_one(bit, gamma),
                            _gamma_or_one(bit, ginv)]))
    cl, cr = _lo_rep(CS, bit, half), _hi_rep(CS, bit, half)
    dl, dr = _lo_rep(DS, bit, half), _hi_rep(DS, bit, half)
    folded = fr.add(torch.stack([cl, dl]),
                    fr.mul(torch.stack([cr, dr]),
                           torch.stack([ginv.expand(n, -1),
                                        gamma.expand(n, -1)])))
    return W[0], W[1], folded[0], folded[1]


def run_ipa_rounds(ts: strobe_dev.TState, table: PointVec,
                   rows: Sequence[int], hcur: PointVec, Wg, Wgp, csd, dsd,
                   n: int):
    """The IPA's log(n) folding rounds as chained device work. Returns
    (lr_blobs [rounds] of [4, 96], gammas [rounds], csd, dsd). Shared by
    the stand-alone device IPA and the full device prove."""
    lr_blobs, gammas = [], []
    for r in range(n.bit_length() - 1):
        half = n >> (r + 1)
        blog = n.bit_length() - 2 - r
        with profiling.span("ipa_round"):
            lr_pts = _ipa_round_cross(table, rows, hcur, Wg, Wgp, csd, dsd,
                                      half, blog)
            blobs, gamma = _round_absorb(ts, lr_pts, LABEL_LOOP, LABEL_GAMMA)
            lr_blobs.append(blobs)
            gammas.append(gamma)
            Wg, Wgp, csd, dsd = _ipa_round_update(
                Wg, Wgp, csd, dsd, gamma, _gamma_inv(gamma), half, blog)
    return lr_blobs, gammas, csd, dsd


def prove_ipa_on_device(crs_gs: List[Affine], crs_gs_prime: List[Affine],
                        crs_h: Affine, C: Affine, D: Affine, z: int,
                        cs: List[int], ds: List[int],
                        transcript: Transcript, rand: Rand, *,
                        device: torch.device,
                        stacked: Optional[curve.StackedVec] = None,
                        diag: Optional[List[int]] = None):
    """Drop-in replacement for inner_product.prove: byte-identical proof,
    the whole recursion on the device, one final fetch.

    stacked: device StackedVec holding the bases. With `diag` (the
    grand-product rescale, grandproductargument.go:94-103) it is the one
    row [Gs|Hs] and Gs' is lazy: row G' = diag * row G, folded into the
    scalar weights. Without diag it holds physical rows [Gs, Gs']."""
    from . import inner_product

    n = len(cs)
    rounds = n.bit_length() - 1
    rs_c, rs_d = inner_product.generate_ipa_blinders(rand, cs, ds)

    with profiling.span("upload"):
        if stacked is None:
            stacked = curve.StackedVec.from_affine([crs_gs, crs_gs_prime],
                                                   device=device, pad_to=n)
        table = stacked.table()
        Wg0 = fr_const([1] * n, device)
        if diag is not None:
            rows = (0, 0, 0, 0)                     # all on row 0
            Wgp0 = fr_const(list(diag[:n]) + [0] * (n - min(n, len(diag))),
                            device)
        else:
            rows = (0, 1, 0, 1)
            Wgp0 = Wg0
        ts = transcript_to_device(transcript, device)
        CD = curve.from_affine_host([C, D], device=device)
        hpt = curve.from_affine_host([crs_h], device=device)
        rs_cv, rs_dv, cs_v, ds_v = (fr_const(v, device)
                                    for v in (rs_c, rs_d, cs, ds))
        zv = fr_scalar(z, device)

    def chain():
        bcd, hcur, csd, dsd = _ipa_setup(table, rows, Wg0, Wgp0, rs_cv,
                                         rs_dv, ts, CD, zv, cs_v, ds_v, hpt)
        lr_blobs, _gammas, csd, dsd = run_ipa_rounds(
            ts, table, rows, hcur, Wg0, Wgp0, csd, dsd, n)
        return ([compress_dev.compress_xy(bcd), fr_bytes_be(csd[:1]),
                 fr_bytes_be(dsd[:1]), ts.st] + lr_blobs)

    b_cd_h, c0h, d0h, sstate, *lr_h = fetch(enqueue(chain))

    with profiling.span("assemble"):
        pt = compress_dev.decode_xy_host
        proof = inner_product.Proof(
            b_c=pt(b_cd_h[0]), b_d=pt(b_cd_h[1]),
            l_cs=[pt(lr_h[r][0]) for r in range(rounds)],
            r_cs=[pt(lr_h[r][2]) for r in range(rounds)],
            l_ds=[pt(lr_h[r][1]) for r in range(rounds)],
            r_ds=[pt(lr_h[r][3]) for r in range(rounds)],
            c0=scalar_of(c0h[0]), d0=scalar_of(d0h[0]))
        sync_host_transcript(transcript, sstate, ts.pos, ts.pos_begin)
    return proof


# ---------------------------------------------------------------------------
# same-multiscalar pieces


def _sm_setup(table: PointVec, r, ts: strobe_dev.TState, azz: PointVec,
              tu_bytes: torch.Tensor, x):
    """Blinder commitments, the step-1 absorb, alpha and the scalar blend
    (samemultiscalarargument.go:63-83). The 2n tracker-point rows absorb
    in one launch: the prover's longest transcript chain."""
    rdig = fr_digits(r)
    b_atu = curve.msm_rows_points_from_table(
        table, torch.stack([rdig, rdig, rdig]), (0, 1, 2))
    append_points_dev(ts, SM_LABEL_STEP1, azz)
    ts.append_rows(SM_LABEL_STEP1, tu_bytes)
    append_points_dev(ts, SM_LABEL_STEP1, b_atu)
    alpha = challenge_fr(ts, SM_LABEL_ALPHA)
    return b_atu, fr.add(r, fr.mul(x, alpha))


def _sm_round_cross(table: PointVec, W, X, half: int, blog: int) -> PointVec:
    n = X.shape[0]
    bit = _fold_bit(n, blog, X.device)
    hi = bit == 1
    # x_L on the high lanes, x_R on the low lanes
    lifted = fr.mul(torch.stack([W, W]),
                    torch.stack([_lo_rep(X, bit, half),
                                 _hi_rep(X, bit, half)]))
    dig = fr_digits(torch.where(torch.stack([hi, ~hi])[..., None], lifted, 0))
    dig6 = dig[:, None].expand(2, 3, -1, -1).reshape((6,) + dig.shape[1:])
    return curve.msm_rows_points_from_table(table, dig6,
                                            (0, 1, 2, 0, 1, 2))     # [6]


def _sm_round_update(W, X, gamma, ginv, half: int, blog: int):
    n = X.shape[0]
    bit = _fold_bit(n, blog, X.device)
    W = fr.mul(W, _gamma_or_one(bit, gamma))
    X = fr.add(_lo_rep(X, bit, half), fr.mul(_hi_rep(X, bit, half), ginv))
    return W, X


def run_sm_rounds(ts: strobe_dev.TState, table: PointVec, W, xd, n: int):
    """Same-multiscalar folding rounds from the weight vector W (uploaded
    ones: the chain itself uploads nothing); see run_ipa_rounds."""
    lr_blobs, gammas = [], []
    for r in range(n.bit_length() - 1):
        half = n >> (r + 1)
        blog = n.bit_length() - 2 - r
        with profiling.span("samemsm_round"):
            lr_pts = _sm_round_cross(table, W, xd, half, blog)
            blobs, gamma = _round_absorb(ts, lr_pts, SM_LABEL_LOOP,
                                         SM_LABEL_GAMMA)
            lr_blobs.append(blobs)
            gammas.append(gamma)
            W, xd = _sm_round_update(W, xd, gamma, _gamma_inv(gamma), half,
                                     blog)
    return lr_blobs, gammas, xd


def prove_samemsm_on_device(G: List[Affine], A: Affine, Z_t: Affine,
                            Z_u: Affine, T: List[Affine], U: List[Affine],
                            x: List[int], transcript: Transcript,
                            rand: Rand, *, device: torch.device):
    """Drop-in replacement for same_multiscalar.prove (same proof bytes)."""
    from . import same_multiscalar

    n = len(x)
    rounds = n.bit_length() - 1
    r = rand.get_frs(n)
    with profiling.span("upload"):
        table = curve.StackedVec.from_affine([G, T, U], device=device,
                                             pad_to=n).table()
        azz = curve.from_affine_host([A, Z_t, Z_u], device=device)
        tu_bytes = strobe_dev.bytes_tensor(point_rows(list(T) + list(U)),
                                           device)
        ts = transcript_to_device(transcript, device)
        r_dev, x_dev = fr_const(r, device), fr_const(x, device)
        ones = fr_const([1] * n, device)

    def chain():
        b_atu, xs = _sm_setup(table, r_dev, ts, azz, tu_bytes, x_dev)
        lr_blobs, _gammas, xs = run_sm_rounds(ts, table, ones, xs, n)
        return ([compress_dev.compress_xy(b_atu), fr_bytes_be(xs[:1]), ts.st]
                + lr_blobs)

    b_h, x0h, sstate, *lr_h = fetch(enqueue(chain))

    with profiling.span("assemble"):
        pt = compress_dev.decode_xy_host
        proof = same_multiscalar.Proof(
            b_a=pt(b_h[0]), b_t=pt(b_h[1]), b_u=pt(b_h[2]),
            l_a=[pt(lr_h[rd][0]) for rd in range(rounds)],
            l_t=[pt(lr_h[rd][1]) for rd in range(rounds)],
            l_u=[pt(lr_h[rd][2]) for rd in range(rounds)],
            r_a=[pt(lr_h[rd][3]) for rd in range(rounds)],
            r_t=[pt(lr_h[rd][4]) for rd in range(rounds)],
            r_u=[pt(lr_h[rd][5]) for rd in range(rounds)],
            x=scalar_of(x0h[0]))
        sync_host_transcript(transcript, sstate, ts.pos, ts.pos_begin)
    return proof
