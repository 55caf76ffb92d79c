"""Zero-knowledge inner-product argument: Bulletproofs-style log-round
folding with blinders (go_curdleproofs_tpu/models/inner_product.py;
innerproductargument.go of the Go reference).

The prover keeps its bases on the device as a `curve.FoldedBases` for the
whole recursion: every round's four cross-term MSMs are one `msm_many`
call, the folds are scalar-side, the Fr vector folds and the Fiat-Shamir
transcript stay on the host. The verifier's two checks defer into the
accumulator as linear combinations: no group operation and no device call.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import BinaryIO, List, Optional, Sequence, Tuple, Union

import torch

from ..ops import curve
from ..utils import codec
from ..utils import field_host as fh
from ..utils.field_host import Affine
from ..utils.rand import Rand
from ..utils.transcript import Transcript
from .device_mode import DEFAULT_PROVER, check_prover
from .msm_accumulator import MsmAccumulator, as_terms

LABEL_STEP1 = b"ipa_step1"
LABEL_ALPHA = b"ipa_alpha"
LABEL_BETA = b"ipa_beta"
LABEL_LOOP = b"ipa_loop"
LABEL_GAMMA = b"ipa_gamma"


@dataclass
class CRS:
    gs: List[Affine]
    gs_prime: List[Affine]
    h: Affine
    # optional device-resident bases: the grand-product prover hands over
    # its one [Gs|Hs] row, whose second row is lazy: Gs'[i] = diag[i] *
    # Gs[i] (grandproductargument.go:94-103): a two-row FoldedBases view for
    # the host prover, the StackedVec itself plus `diag` for the device one
    stacked: Optional[Union[curve.FoldedBases, curve.StackedVec]] = None
    diag: Optional[List[int]] = None


@dataclass
class Proof:
    b_c: Affine
    b_d: Affine
    l_cs: List[Affine] = field(default_factory=list)
    r_cs: List[Affine] = field(default_factory=list)
    l_ds: List[Affine] = field(default_factory=list)
    r_ds: List[Affine] = field(default_factory=list)
    c0: int = 0
    d0: int = 0

    def serialize(self, w: BinaryIO) -> None:
        e = codec.Encoder(w)
        e.write_point(self.b_c)
        e.write_point(self.b_d)
        e.write_points(self.l_cs)
        e.write_points(self.r_cs)
        e.write_points(self.l_ds)
        e.write_points(self.r_ds)
        e.write_fr(self.c0)
        e.write_fr(self.d0)

    @classmethod
    def from_reader(cls, r: BinaryIO) -> "Proof":
        d = codec.Decoder(r)
        return cls(d.read_point(), d.read_point(),
                   d.read_points(), d.read_points(),
                   d.read_points(), d.read_points(),
                   d.read_fr(), d.read_fr())


def generate_ipa_blinders(rand: Rand, cs: Sequence[int],
                          ds: Sequence[int]) -> Tuple[List[int], List[int]]:
    """Solve blinders rs, zs with <rs,ds>+<zs,cs>=0 and <rs,zs>=0
    (innerproductargument.go:299-391; same draw order, same 2x2 solve)."""
    n = len(cs)
    rs = rand.get_frs(n)
    zs = rand.get_frs(n - 2)

    omega = (fh.fr_inner_product(rs, list(ds))
             + fh.fr_inner_product(zs[: n - 2], list(cs[: n - 2]))) % fh.R
    delta = fh.fr_inner_product(rs[: n - 2], zs[: n - 2])

    inv_c = fh.fr_inv(cs[n - 2])
    last_z_term1 = (rs[n - 2] * inv_c % fh.R * omega - delta) % fh.R
    last_z_term2 = (-rs[n - 2] * inv_c % fh.R * cs[n - 1] + rs[n - 1]) % fh.R
    if last_z_term2 == 0:
        raise ValueError("last_z_term2 is zero")
    last_z = last_z_term1 * fh.fr_inv(last_z_term2) % fh.R
    penultimate_z = (-inv_c) * ((last_z * cs[n - 1] + omega) % fh.R) % fh.R

    zs = zs + [penultimate_z, last_z]

    if (fh.fr_inner_product(rs, list(ds))
            + fh.fr_inner_product(zs, list(cs))) % fh.R != 0:
        raise ValueError("IPA blinders: constraint 1 not satisfied")
    if fh.fr_inner_product(rs, zs) != 0:
        raise ValueError("IPA blinders: constraint 2 not satisfied")
    return rs, zs


def prove(crs: CRS, C: Affine, D: Affine, z: int, cs: List[int],
          ds: List[int], transcript: Transcript, rand: Rand, *,
          device: torch.device, prover: str = DEFAULT_PROVER) -> Proof:
    """innerproductargument.go:42-188. prover="device" runs the whole
    recursion device-resident (models/device_prover2.py), same bytes."""
    if len(cs) != len(ds):
        raise ValueError("cs and ds are not the same length")
    n = len(cs)
    if n & (n - 1) != 0:
        raise ValueError("cs and ds are not a power of two")

    if check_prover(prover) == "device":
        from . import device_prover2
        stacked = crs.stacked
        if isinstance(stacked, curve.FoldedBases):
            stacked = stacked.sv
        return device_prover2.prove_ipa_on_device(
            crs.gs, crs.gs_prime, crs.h, C, D, z, cs, ds, transcript, rand,
            device=device, stacked=stacked, diag=crs.diag)

    # Step 1
    rs_c, rs_d = generate_ipa_blinders(rand, cs, ds)
    gg = crs.stacked if crs.stacked is not None else \
        curve.FoldedBases.from_affine([crs.gs, crs.gs_prime], device=device)
    b_c, b_d = gg.msm_many([[(0, rs_c, 0)], [(1, rs_d, 0)]])

    transcript.append_points(LABEL_STEP1, C, D)
    transcript.append_scalars(LABEL_STEP1, z)
    transcript.append_points(LABEL_STEP1, b_c, b_d)
    alpha = transcript.get_and_append_challenge(LABEL_ALPHA)
    beta = transcript.get_and_append_challenge(LABEL_BETA)

    cs = [(rc + alpha * c) % fh.R for rc, c in zip(rs_c, cs)]
    ds = [(rd + alpha * d) % fh.R for rd, d in zip(rs_d, ds)]
    H = fh.g1_mul(crs.h, beta)

    # Step 2: log(n) folding rounds
    l_cs: List[Affine] = []
    r_cs: List[Affine] = []
    l_ds: List[Affine] = []
    r_ds: List[Affine] = []

    while len(cs) > 1:
        half = len(cs) // 2
        c_l, c_r = cs[:half], cs[half:]
        d_l, d_r = ds[:half], ds[half:]

        # all four cross-term MSMs in one device call + one fetch;
        # L_C = <c_L, G_R> + IPA(c_L, d_R)*H ; L_D = <d_R, G'_L>
        l_c0, l_d, r_c0, r_d = gg.msm_many([
            [(0, c_l, half)], [(1, d_r, 0)],
            [(0, c_r, 0)], [(1, d_l, half)]])
        l_c = fh.g1_add(l_c0, fh.g1_mul(H, fh.fr_inner_product(c_l, d_r)))
        r_c = fh.g1_add(r_c0, fh.g1_mul(H, fh.fr_inner_product(c_r, d_l)))

        l_cs.append(l_c)
        l_ds.append(l_d)
        r_cs.append(r_c)
        r_ds.append(r_d)

        transcript.append_points(LABEL_LOOP, l_c, l_d, r_c, r_d)
        gamma = transcript.get_and_append_challenge(LABEL_GAMMA)
        if gamma == 0:
            raise ValueError("ipa gamma challenge is zero")
        gamma_inv = fh.fr_inv(gamma)

        cs = [(cl + gamma_inv * cr) % fh.R for cl, cr in zip(c_l, c_r)]
        ds = [(dl + gamma * dr) % fh.R for dl, dr in zip(d_l, d_r)]
        gg = gg.fold([gamma, gamma_inv])

    return Proof(b_c, b_d, l_cs, r_cs, l_ds, r_ds, cs[0], ds[0])


def verify(proof: Proof, crs: CRS, C, D, z: int, us: List[int],
           transcript: Transcript, msm_accumulator: MsmAccumulator,
           rand: Rand) -> bool:
    """C and D may be points or [(point, coeff)] linear combinations."""
    transcript.append_points(LABEL_STEP1, C, D)
    transcript.append_scalars(LABEL_STEP1, z)
    transcript.append_points(LABEL_STEP1, proof.b_c, proof.b_d)
    alpha = transcript.get_and_append_challenge(LABEL_ALPHA)
    beta = transcript.get_and_append_challenge(LABEL_BETA)

    n = len(crs.gs)
    if n & (n - 1) != 0:
        raise ValueError("ipa n is not a power of two")
    m = n.bit_length() - 1

    gamma: List[int] = []
    for i in range(m):
        transcript.append_points(LABEL_LOOP, proof.l_cs[i], proof.l_ds[i],
                                 proof.r_cs[i], proof.r_ds[i])
        gamma.append(transcript.get_and_append_challenge(LABEL_GAMMA))
    gamma_inv = fh.fr_batch_inv(gamma)

    # s[i] = prod gamma_j^{bit_j(i)} (s' with inverses), built by doubling
    s = [1]
    s_prime = [1]
    for j in range(m):
        g = gamma[m - j - 1]
        gi = gamma_inv[m - j - 1]
        s = s + [x * g % fh.R for x in s]
        s_prime = s_prime + [x * gi % fh.R for x in s_prime]

    # check 1: B_c + alpha*C + (alpha^2 z beta)*H + <gamma, L_C>
    #          + <gamma^-1, R_C> == <s*c0, Gs> + (beta d0 c0)*H
    alpha2zb = alpha * alpha % fh.R * z % fh.R * beta % fh.R
    ac1 = ([(proof.b_c, 1), (crs.h, alpha2zb)] + as_terms(C, alpha)
           + list(zip(proof.l_cs, gamma))
           + list(zip(proof.r_cs, gamma_inv)))
    scalars = [si * proof.c0 % fh.R for si in s]
    scalars.append(beta * proof.d0 % fh.R * proof.c0 % fh.R)
    msm_accumulator.accumulate_check(ac1, scalars, list(crs.gs) + [crs.h],
                                     rand)

    # check 2: B_d + alpha*D + <gamma, L_D> + <gamma^-1, R_D>
    #          == <s' * us * d0, Gs>
    ac2 = ([(proof.b_d, 1)] + as_terms(D, alpha)
           + list(zip(proof.l_ds, gamma))
           + list(zip(proof.r_ds, gamma_inv)))
    scalars2 = [sp * ui % fh.R * proof.d0 % fh.R
                for sp, ui in zip(s_prime, us)]
    msm_accumulator.accumulate_check(ac2, scalars2, list(crs.gs), rand)
    return True
