"""Grand-product argument (go_curdleproofs_tpu/models/grand_product.py;
grandproductargument.go of the Go reference): reduces prod bs[i] = p to an
inner-product argument over rescaled bases.

The prover keeps ONE base row [Gs|Hs] on the device; the rescaled bases
Gs' = Gs * beta^-i are a scalar-side diagonal of a `curve.FoldedBases`, so
there is no device rescale and the multiples table builds once. The
verifier needs O(1) group operations through Gsum/Hsum."""

from __future__ import annotations

from dataclasses import dataclass
from typing import BinaryIO, List

import torch

from ..ops import curve
from ..utils import codec
from ..utils import field_host as fh
from ..utils.field_host import Affine
from ..utils.rand import Rand
from ..utils.transcript import Transcript
from . import inner_product
from .device_mode import DEFAULT_PROVER, check_prover
from .msm_accumulator import MsmAccumulator

LABEL_STEP1 = b"gprod_step1"
LABEL_STEP2 = b"gprod_step2"
LABEL_ALPHA = b"gprod_alpha"
LABEL_BETA = b"gprod_beta"


@dataclass
class CRS:
    gs: List[Affine]
    hs: List[Affine]
    h: Affine


@dataclass
class Proof:
    c: Affine
    r_p: int
    ipa_proof: inner_product.Proof

    def serialize(self, w: BinaryIO) -> None:
        e = codec.Encoder(w)
        e.write_point(self.c)
        e.write_fr(self.r_p)
        self.ipa_proof.serialize(w)

    @classmethod
    def from_reader(cls, r: BinaryIO) -> "Proof":
        d = codec.Decoder(r)
        c = d.read_point()
        r_p = d.read_fr()
        return cls(c, r_p, inner_product.Proof.from_reader(r))


def prove(crs: CRS, B: Affine, result: int, bs: List[int], r_bs: List[int],
          transcript: Transcript, rand: Rand, *,
          device: torch.device, prover: str = DEFAULT_PROVER) -> Proof:
    """grandproductargument.go:42-204. With prover="device" the
    inner-product argument runs device-resident on the same one-row
    bases."""
    check_prover(prover)
    ell = len(crs.gs)

    # Step 1
    transcript.append_points(LABEL_STEP1, B)
    transcript.append_scalars(LABEL_STEP1, result)
    alpha = transcript.get_and_append_challenge(LABEL_ALPHA)

    # Step 2: partial products cs[0]=1, cs[i] = cs[i-1]*bs[i-1]
    cs = [1] * ell
    for i in range(1, ell):
        cs[i] = cs[i - 1] * bs[i - 1] % fh.R
    r_cs = rand.get_frs(len(r_bs))
    width = len(crs.gs) + len(crs.hs)
    # ONE device-resident base row [Gs|Hs] (the IPA's concatenated bases,
    # lane i = Gs[i] for i < ell, Hs[i-ell] after); every MSM below and all
    # of the IPA's address it through scalar-side transforms (FoldedBases),
    # so its multiples table is built exactly once.
    ghsv = curve.StackedVec.from_affine([list(crs.gs) + list(crs.hs)],
                                        device=device, pad_to=width)
    gh = curve.FoldedBases(ghsv)
    (C,) = gh.msm_many([[(0, list(cs) + list(r_cs), 0)]])

    r_b_plus_alpha = [(rb + alpha) % fh.R for rb in r_bs]
    r_p = fh.fr_inner_product(r_b_plus_alpha, r_cs)

    transcript.append_points(LABEL_STEP2, C)
    transcript.append_scalars(LABEL_STEP2, r_p)
    beta = transcript.get_and_append_challenge(LABEL_BETA)
    if beta == 0:
        raise ValueError("beta is zero")

    # Step 3: rescaled bases Gs' = Gs*beta^-i, Hs' = Hs*beta^-(ell+1)
    # (grandproductargument.go:94-103) as a scalar-side diagonal:
    # <v, Gs'|Hs'> = <v*diag, Gs|Hs>.
    beta_inv = fh.fr_inv(beta)
    beta_inv_pows = []
    acc = beta_inv
    for _ in range(ell):
        beta_inv_pows.append(acc)
        acc = acc * beta_inv % fh.R
    # acc == beta_inv^(ell+1)
    diag = beta_inv_pows + [acc] * len(crs.hs)
    gh_prime = curve.FoldedBases(ghsv, rows=[0], diags={0: diag})

    bs_prime = []
    tmp_beta = beta
    for i in range(ell):
        bs_prime.append(bs[i] * tmp_beta % fh.R)
        tmp_beta = tmp_beta * beta % fh.R

    ds = []
    beta_powers = []
    pw = 1
    for i in range(ell):
        ds.append((bs_prime[i] - pw) % fh.R)
        beta_powers.append(pw)
        pw = pw * beta % fh.R
    # pw == beta^ell

    beta_exp_l_plus_1 = pow(beta, ell + 1, fh.R)
    r_ds = [beta_exp_l_plus_1 * v % fh.R for v in r_b_plus_alpha]
    alpha_beta = [alpha * beta_exp_l_plus_1 % fh.R] * len(r_bs)

    z = (r_p * beta_exp_l_plus_1 + result * pw - 1) % fh.R
    cs_full = cs + r_cs
    ds_full = ds + r_ds

    # D = B - <beta_powers, Gs'> + <alpha*beta^(l+1), Hs'>, and the prover
    # self-check msm(G', d) (grandproductargument.go:111-177) in one call.
    neg_beta_powers = [(-b) % fh.R for b in beta_powers]
    d_part, selfcheck2 = gh_prime.msm_many([
        [(0, neg_beta_powers + alpha_beta, 0)],
        [(0, ds + r_ds, 0)]])
    D = fh.g1_add(B, d_part)

    # prover self-checks (grandproductargument.go:156-177); msm(G,c)==C is
    # what computed C above, so only the scalar identity and G' check remain
    if fh.fr_inner_product(cs_full, ds_full) != z:
        raise ValueError("IPA(C, D) != z")
    if selfcheck2 != D:
        raise ValueError("msm(G', d) != D")

    if prover == "device":
        # the device IPA uses the SAME one-row bases and table; Gs'|Hs' is
        # lazy (row G' = diag * row G, folded into the scalar weights)
        merged = curve.StackedVec(ghsv.pv, ell + len(crs.hs))
    else:
        # lazy 2-row view of the SAME device bases:
        # row 0 = [Gs|Hs], row 1 = [Gs'|Hs'] = diag * [Gs|Hs]
        merged = curve.FoldedBases(ghsv, rows=[0, 0], diags={1: diag},
                                   n_valid=ell + len(crs.hs))
    ipa_crs = inner_product.CRS(list(crs.gs) + list(crs.hs), [], crs.h,
                                stacked=merged, diag=diag)
    ipa_proof = inner_product.prove(ipa_crs, C, D, z, cs_full, ds_full,
                                    transcript, rand, device=device,
                                    prover=prover)
    return Proof(C, r_p, ipa_proof)


def verify(proof: Proof, crs: CRS, gsum: Affine, hsum: Affine, B: Affine,
           result: int, num_blinders: int, transcript: Transcript,
           msm_accumulator: MsmAccumulator, rand: Rand) -> bool:
    ell = len(crs.gs)

    transcript.append_points(LABEL_STEP1, B)
    transcript.append_scalars(LABEL_STEP1, result)
    alpha = transcript.get_and_append_challenge(LABEL_ALPHA)

    transcript.append_points(LABEL_STEP2, proof.c)
    transcript.append_scalars(LABEL_STEP2, proof.r_p)
    beta = transcript.get_and_append_challenge(LABEL_BETA)
    if beta == 0:
        raise ValueError("beta is zero")

    # us[i] = beta^-(i+1) for i < ell, then beta^-(ell+1) for the blinders
    beta_inv = fh.fr_inv(beta)
    us = []
    acc = beta_inv
    for _ in range(ell):
        us.append(acc)
        acc = acc * beta_inv % fh.R
    us.extend([acc] * num_blinders)

    # D = B - beta^-1*Gsum + alpha*Hsum enters the IPA transcript, so it is
    # one of the few points a verification materialises
    D = fh.g1_sub(codec.resolve_point(B), fh.g1_mul(gsum, beta_inv))
    D = fh.g1_add(D, fh.g1_mul(hsum, alpha))

    gs_full = list(crs.gs) + list(crs.hs)
    beta_exp_l = pow(beta, ell, fh.R)
    z = (proof.r_p * beta_exp_l % fh.R * beta + result * beta_exp_l - 1) % fh.R

    ipa_crs = inner_product.CRS(gs_full, [], crs.h)
    return inner_product.verify(proof.ipa_proof, ipa_crs, proof.c, D, z, us,
                                transcript, msm_accumulator, rand)
