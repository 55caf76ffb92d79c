"""Curdleproofs shuffle argument (go_curdleproofs_tpu/models/
curdleproof.py; curdleproof.go and crs.go of the Go reference).

  Step 1: Fiat-Shamir challenges `as` from the instance (Rs, Ss, Ts, Us, M);
  Step 2: commit A = <perm(as), Gs> + <rs_a', Hs>; same-permutation argument;
  Step 3: R = <as, Rs>, S = <as, Ss>; T = com(k*R), U = com(k*S); same-scalar;
  Step 4: same-multiscalar over the concatenated bases.

The default prove is host logic over one device API (`curve.StackedVec.msm_many` behind
`curve.FoldedBases`) and `curve.batch_scalar_mul`; the transcript order and
the order of draws from `rand` fix the proof bytes. Verify replays the
transcript, runs the sub-verifiers in the reference's order and defers
every group identity into one MsmAccumulator, whose final MSM is the
verification's one device MSM.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import BinaryIO, Dict, List, Optional, Sequence, Tuple

import torch

from ..ops import curve
from ..utils import codec
from ..utils import field_host as fh
from ..utils.field_host import Affine
from ..utils.rand import Rand
from ..utils.transcript import Transcript
from . import same_multiscalar, same_permutation, same_scalar
from .device_mode import DEFAULT_PROVER, check_prover
from .group_commitment import GroupCommitment
from .msm_accumulator import MsmAccumulator, StaticBases

LABEL_TRANSCRIPT = b"curdleproofs"
LABEL_STEP1 = b"curdleproofs_step1"
LABEL_VEC_A = b"curdleproofs_vec_a"

N_BLINDERS = 4


@dataclass
class CRS:
    gs: List[Affine]
    hs: List[Affine]
    h: Affine
    gt: Affine
    gu: Affine
    gsum: Affine
    hsum: Affine


def generate_crs(size: int, rand: Rand, *, device: torch.device) -> CRS:
    """crs.go:20-59 with the same Rand draw order; the size + N_BLINDERS + 3
    generator multiples run as one batched scalar multiplication."""
    scalars = [rand.get_fr() for _ in range(size)]
    h_scalars = [rand.get_fr() for _ in range(N_BLINDERS)]
    hgtgu = [rand.get_fr() for _ in range(3)]
    pts = curve.batch_scalar_mul([fh.G1_GEN] * (size + N_BLINDERS + 3),
                                 scalars + h_scalars + hgtgu, device=device)
    gs = pts[:size]
    hs = pts[size:size + N_BLINDERS]
    h, gt, gu = pts[size + N_BLINDERS:]
    gsum = None
    for g in gs:
        gsum = fh.g1_add(gsum, g)
    hsum = None
    for hh in hs:
        hsum = fh.g1_add(hsum, hh)
    return CRS(gs, hs, h, gt, gu, gsum, hsum)


@dataclass
class Proof:
    a: Affine
    cm_t: GroupCommitment
    cm_u: GroupCommitment
    r: Affine
    s: Affine
    proof_same_permutation: same_permutation.Proof
    proof_same_scalar: same_scalar.Proof
    proof_same_multiscalar: same_multiscalar.Proof

    def serialize(self, w: BinaryIO) -> None:
        e = codec.Encoder(w)
        e.write_point(self.a)
        self.cm_t.serialize(w)
        self.cm_u.serialize(w)
        e.write_point(self.r)
        e.write_point(self.s)
        self.proof_same_permutation.serialize(w)
        self.proof_same_scalar.serialize(w)
        self.proof_same_multiscalar.serialize(w)

    @classmethod
    def from_reader(cls, r: BinaryIO) -> "Proof":
        d = codec.Decoder(r)
        a = d.read_point()
        cm_t = GroupCommitment.from_reader(r)
        cm_u = GroupCommitment.from_reader(r)
        rr = d.read_point()
        s = d.read_point()
        return cls(a, cm_t, cm_u, rr, s,
                   same_permutation.Proof.from_reader(r),
                   same_scalar.Proof.from_reader(r),
                   same_multiscalar.Proof.from_reader(r))


def prove(crs: CRS, Rs: List[Affine], Ss: List[Affine], Ts: List[Affine],
          Us: List[Affine], M: Affine, perm: Sequence[int], k: int,
          rs_m: List[int], rand: Rand, *, device: torch.device,
          prover: str = DEFAULT_PROVER) -> Proof:
    """curdleproof.go:38-197. prover="host": host-orchestrated, every MSM
    is a device call, the transcript and the Fr arithmetic run on the host.
    prover="device": the whole prove as one chain of device work with a
    single fetch (models/device_prover_full.py), byte-identical."""
    if check_prover(prover) == "device":
        from . import device_prover_full
        return device_prover_full.prove_on_device(
            crs, Rs, Ss, Ts, Us, M, perm, k, rs_m, rand, device=device)

    transcript = Transcript(LABEL_TRANSCRIPT)

    # Step 1
    transcript.append_points(LABEL_STEP1, *Rs)
    transcript.append_points(LABEL_STEP1, *Ss)
    transcript.append_points(LABEL_STEP1, *Ts)
    transcript.append_points(LABEL_STEP1, *Us)
    transcript.append_points(LABEL_STEP1, M)
    as_ = transcript.get_and_append_challenges(LABEL_VEC_A, len(Rs))

    # Step 2
    rs_a = rand.get_frs(N_BLINDERS - 2)
    rs_a_prime = rs_a + [0, 0]
    perm_as = same_permutation.permute(as_, perm)
    gh = curve.StackedVec.from_affine([crs.gs, crs.hs], device=device)
    (A,) = gh.msm_many([[(0, perm_as, 0), (1, rs_a_prime, 0)]])

    proof_same_perm = same_permutation.prove(
        same_permutation.CRS(crs.gs, crs.hs, crs.h),
        A, M, as_, perm, rs_a_prime, rs_m, transcript, rand, device=device)

    # Step 3
    r_t = rand.get_fr()
    r_u = rand.get_fr()
    R, S = curve.StackedVec.from_affine([Rs, Ss], device=device).msm_many(
        [[(0, as_, 0)], [(1, as_, 0)]])
    cm_t = GroupCommitment.new(crs.gt, crs.h, fh.g1_mul(R, k), r_t)
    cm_u = GroupCommitment.new(crs.gu, crs.h, fh.g1_mul(S, k), r_u)

    proof_same_scalar = same_scalar.prove(
        same_scalar.CRS(crs.gt, crs.gu, crs.h),
        R, S, cm_t, cm_u, k, r_t, r_u, transcript, rand)

    # Step 4: concatenated instance for the same-multiscalar argument
    a_prime = fh.g1_add(A, fh.g1_add(cm_t.t1, cm_u.t1))
    G = list(crs.gs) + list(crs.hs[: N_BLINDERS - 2]) + [crs.gt, crs.gu]
    T_prime = list(Ts) + [None, None, crs.h, None]
    U_prime = list(Us) + [None, None, None, crs.h]
    x = perm_as + rs_a + [r_t, r_u]

    proof_same_msm = same_multiscalar.prove(
        G, a_prime, cm_t.t2, cm_u.t2, T_prime, U_prime, x, transcript, rand,
        device=device)

    return Proof(A, cm_t, cm_u, R, S, proof_same_perm, proof_same_scalar,
                 proof_same_msm)


def verify(proof: Proof, crs: CRS, Rs: List[Affine], Ss: List[Affine],
           Ts: List[Affine], Us: List[Affine], M: Affine, rand: Rand, *,
           device: torch.device,
           accumulator: Optional[MsmAccumulator] = None) -> bool:
    """curdleproof.go:199-318.

    accumulator: a caller-owned MsmAccumulator. This proof's deferred checks
    fold into it and the caller runs the one final MSM (batched
    verification); True then means that nothing failed before that MSM.
    Without it a local accumulator is made and verified here."""
    transcript = Transcript(LABEL_TRANSCRIPT)
    deferred = accumulator is not None
    msm_accumulator = accumulator if deferred else MsmAccumulator(
        device=device, static_bases=_gh_static(crs, device))

    # reject a zero randomizer that wiped the ciphertexts
    if codec.point_is_infinity(Ts[0]):
        raise ValueError("randomizer is zero")

    # Step 1
    transcript.append_points(LABEL_STEP1, *Rs)
    transcript.append_points(LABEL_STEP1, *Ss)
    transcript.append_points(LABEL_STEP1, *Ts)
    transcript.append_points(LABEL_STEP1, *Us)
    transcript.append_points(LABEL_STEP1, M)
    as_ = transcript.get_and_append_challenges(LABEL_VEC_A, len(Rs))

    # Step 2
    if not same_permutation.verify(
            proof.proof_same_permutation,
            same_permutation.CRS(crs.gs, crs.hs, crs.h),
            crs.gsum, crs.hsum, proof.a, M, as_, N_BLINDERS,
            transcript, msm_accumulator, rand):
        return False

    # Step 3 (deferred into the accumulator)
    if not same_scalar.verify(
            proof.proof_same_scalar, same_scalar.CRS(crs.gt, crs.gu, crs.h),
            proof.r, proof.s, proof.cm_t, proof.cm_u, transcript,
            msm_accumulator, rand):
        return False

    # Step 4 (a_prime enters the same-msm transcript, so it materialises)
    a_prime = fh.g1_add(codec.resolve_point(proof.a),
                        fh.g1_add(codec.resolve_point(proof.cm_t.t1),
                                  codec.resolve_point(proof.cm_u.t1)))
    G = list(crs.gs) + list(crs.hs[: N_BLINDERS - 2]) + [crs.gt, crs.gu]
    Ts_prime = list(Ts) + [None, None, crs.h, None]
    Us_prime = list(Us) + [None, None, None, crs.h]
    if not same_multiscalar.verify(
            proof.proof_same_multiscalar, G, a_prime, proof.cm_t.t2,
            proof.cm_u.t2, Ts_prime, Us_prime, transcript,
            msm_accumulator, rand):
        return False

    msm_accumulator.accumulate_check(proof.r, as_, Rs, rand)
    msm_accumulator.accumulate_check(proof.s, as_, Ss, rand)
    if deferred:
        return True
    return msm_accumulator.verify()


_GhKey = Tuple[tuple, tuple, torch.device]
_gh_cache: Dict[_GhKey, curve.StackedVec] = {}
_gh_static_cache: Dict[_GhKey, StaticBases] = {}
_GH_CACHE_MAX = 4


def _gh_stacked(crs_gs, crs_hs, device: torch.device) -> curve.StackedVec:
    """The one-row [Gs|Hs] bases on `device` with their multiples table,
    cached per CRS content and device: the shuffle commit and the verifier
    address the same device bases, so the upload and the table build happen
    once per CRS, device and process. Content keys (the point tuples
    themselves) hold strong references, so a freed CRS can never alias a
    live entry."""
    key = (tuple(crs_gs), tuple(crs_hs), device)
    sv = _gh_cache.get(key)
    if sv is None:
        if len(_gh_cache) >= _GH_CACHE_MAX:
            _gh_cache.clear()
        sv = curve.StackedVec.from_affine(
            [list(crs_gs) + list(crs_hs)], device=device,
            pad_to=len(crs_gs) + len(crs_hs))
        _gh_cache[key] = sv
    return sv


def _gh_static(crs: CRS, device: torch.device) -> StaticBases:
    """StaticBases view of the CRS [Gs|Hs] row for the accumulator."""
    key = (tuple(crs.gs), tuple(crs.hs), device)
    ent = _gh_static_cache.get(key)
    if ent is None:
        if len(_gh_static_cache) >= _GH_CACHE_MAX:
            _gh_static_cache.clear()
        ent = StaticBases(_gh_stacked(crs.gs, crs.hs, device),
                          list(crs.gs) + list(crs.hs))
        _gh_static_cache[key] = ent
    return ent


def shuffle_permute_commit(crs_gs: List[Affine], crs_hs: List[Affine],
                           Rs: List[Affine], Ss: List[Affine],
                           perm: Sequence[int], k: int, rand: Rand, *,
                           device: torch.device):
    """The shuffle itself: Ts = perm(k*Rs), Us = perm(k*Ss),
    M = <perm-range, Gs> + <rs_m, Hs> (common/util.go:45-88 of the Go
    reference). The 2n randomizer scalar multiplications are one batched
    device call. Returns (Ts, Us, M, rs_m)."""
    n = len(Rs)
    scaled = curve.batch_scalar_mul(list(Rs) + list(Ss), [k] * (2 * n),
                                    device=device)
    Ts = same_permutation.permute(scaled[:n], perm)
    Us = same_permutation.permute(scaled[n:], perm)

    perm_range = same_permutation.permute(list(range(len(crs_gs))), perm)
    rs_m = rand.get_frs(N_BLINDERS)
    (M,) = _gh_stacked(crs_gs, crs_hs, device).msm_many(
        [[(0, perm_range, 0), (0, rs_m, len(crs_gs))]])
    return Ts, Us, M, rs_m
