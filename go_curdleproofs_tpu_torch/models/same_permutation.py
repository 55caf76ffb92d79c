"""Same-permutation argument (go_curdleproofs_tpu/models/
same_permutation.py; samepermutationargument.go of the Go reference): a
Neff-style reduction of "A commits to a permutation of as, the one that M
commits to" to a grand product. The prover is host-orchestrated only;
the one-fetch device prover has its own pieces
(models/device_prover_full.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import BinaryIO, List, Sequence

import torch

from ..utils import codec
from ..utils import field_host as fh
from ..utils import profiling
from ..utils.field_host import Affine
from ..utils.rand import Rand
from ..utils.transcript import Transcript
from . import grand_product
from .msm_accumulator import MsmAccumulator

LABEL_STEP1 = b"same_perm_step1"
LABEL_ALPHA = b"same_perm_alpha"
LABEL_BETA = b"same_perm_beta"


@dataclass
class CRS:
    gs: List[Affine]
    hs: List[Affine]
    h: Affine


@dataclass
class Proof:
    b: Affine
    gpa_proof: grand_product.Proof

    def serialize(self, w: BinaryIO) -> None:
        codec.Encoder(w).write_point(self.b)
        self.gpa_proof.serialize(w)

    @classmethod
    def from_reader(cls, r: BinaryIO) -> "Proof":
        b = codec.Decoder(r).read_point()
        return cls(b, grand_product.Proof.from_reader(r))


def permute(vs: Sequence, perm: Sequence[int]) -> list:
    """ret[i] = vs[perm[i]] (common/util.go:37-43 of the Go reference)."""
    return [vs[p] for p in perm]


@profiling.traced("same_permutation.prove")
def prove(crs: CRS, A: Affine, M: Affine, as_: List[int],
          permutation: Sequence[int], rs_a: List[int], rs_m: List[int],
          transcript: Transcript, rand: Rand, *,
          device: torch.device) -> Proof:
    """samepermutationargument.go:32-101."""
    # Step 1
    transcript.append_points(LABEL_STEP1, A, M)
    transcript.append_scalars(LABEL_STEP1, *as_)
    alpha = transcript.get_and_append_challenge(LABEL_ALPHA)
    beta = transcript.get_and_append_challenge(LABEL_BETA)

    # Step 2: bs[i] = a_perm(i) + alpha*perm(i) + beta; p = prod bs
    permuted_as = permute(as_, permutation)
    bs = []
    p = 1
    for i, perm_i in enumerate(permutation):
        b_i = (alpha * perm_i + permuted_as[i] + beta) % fh.R
        bs.append(b_i)
        p = p * b_i % fh.R

    # <beta..beta, Gs> == beta * (sum Gs): two host scalar multiplications
    # instead of a device MSM (the group element is identical)
    with profiling.span("group"):
        gsum = None
        for g in crs.gs:
            gsum = fh.g1_add(gsum, g)
        B = fh.g1_add(A, fh.g1_add(fh.g1_mul(M, alpha),
                                   fh.g1_mul(gsum, beta)))

    rs_b = [(alpha * rm + ra) % fh.R for ra, rm in zip(rs_a, rs_m)]

    gpa_proof = grand_product.prove(
        grand_product.CRS(crs.gs, crs.hs, crs.h), B, p, bs, rs_b,
        transcript, rand, device=device)
    return Proof(B, gpa_proof)


@profiling.traced("same_permutation.verify")
def verify(proof: Proof, crs: CRS, gsum: Affine, hsum: Affine,
           A: Affine, M: Affine, as_: List[int], num_blinders: int,
           transcript: Transcript, msm_accumulator: MsmAccumulator,
           rand: Rand) -> bool:
    transcript.append_points(LABEL_STEP1, A, M)
    transcript.append_scalars(LABEL_STEP1, *as_)
    alpha = transcript.get_and_append_challenge(LABEL_ALPHA)
    beta = transcript.get_and_append_challenge(LABEL_BETA)

    # p = prod(as[i] + alpha*i + beta)
    p = 1
    for i, a_i in enumerate(as_):
        p = p * ((i * alpha + beta + a_i) % fh.R) % fh.R

    # B - A - alpha*M == <beta..beta, Gs>, deferred as a linear combination
    C = [(proof.b, 1), (A, -1), (M, (-alpha) % fh.R)]
    msm_accumulator.accumulate_check(C, [beta] * len(crs.gs), crs.gs, rand)

    return grand_product.verify(
        proof.gpa_proof, grand_product.CRS(crs.gs, crs.hs, crs.h),
        gsum, hsum, proof.b, p, num_blinders, transcript,
        msm_accumulator, rand)
