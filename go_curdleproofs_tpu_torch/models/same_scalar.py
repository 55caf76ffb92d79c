"""Same-scalar argument (Chaum-Pedersen-style sigma protocol).

Proves T = com(k*R), U = com(k*S) use the same scalar k. The port's own
copy of go_curdleproofs_tpu/models/same_scalar.py
(samescalarargument/samescalarargument.go of the Go reference), including
transcript labels and the eager (non-accumulated) verification. Host group
operations only: no device call; the verifier's identities defer into the
port's MsmAccumulator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import BinaryIO, Optional

from ..utils import codec
from ..utils import field_host as fh
from ..utils.field_host import Affine
from ..utils.rand import Rand
from ..utils.transcript import Transcript
from .group_commitment import GroupCommitment
from .msm_accumulator import MsmAccumulator

LABEL_POINTS = b"sameexp_points"
LABEL_ALPHA = b"sameexp_alpha"


@dataclass
class CRS:
    gt: Affine
    gu: Affine
    h: Affine


@dataclass
class Proof:
    a: GroupCommitment
    b: GroupCommitment
    z_k: int
    z_t: int
    z_u: int

    def serialize(self, w: BinaryIO) -> None:
        self.a.serialize(w)
        self.b.serialize(w)
        e = codec.Encoder(w)
        e.write_fr(self.z_k)
        e.write_fr(self.z_t)
        e.write_fr(self.z_u)

    @classmethod
    def from_reader(cls, r: BinaryIO) -> "Proof":
        a = GroupCommitment.from_reader(r)
        b = GroupCommitment.from_reader(r)
        d = codec.Decoder(r)
        return cls(a, b, d.read_fr(), d.read_fr(), d.read_fr())


def prove(crs: CRS, R: Affine, S: Affine, T: GroupCommitment,
          U: GroupCommitment, k: int, r_t: int, r_u: int,
          transcript: Transcript, rand: Rand) -> Proof:
    """samescalarargument.go:34-81 (same randomness draw order)."""
    r_a = rand.get_fr()
    r_b = rand.get_fr()
    r_k = rand.get_fr()

    a = GroupCommitment.new(crs.gt, crs.h, fh.g1_mul(R, r_k), r_a)
    b = GroupCommitment.new(crs.gu, crs.h, fh.g1_mul(S, r_k), r_b)

    transcript.append_points(LABEL_POINTS, R, S, T.t1, T.t2, U.t1, U.t2,
                             a.t1, a.t2, b.t1, b.t2)
    alpha = transcript.get_and_append_challenge(LABEL_ALPHA)

    z_k = (r_k + k * alpha) % fh.R
    z_t = (r_a + r_t * alpha) % fh.R
    z_u = (r_b + r_u * alpha) % fh.R
    return Proof(a, b, z_k, z_t, z_u)


def verify(proof: Proof, crs: CRS, R: Affine, S: Affine,
           T: GroupCommitment, U: GroupCommitment,
           transcript: Transcript,
           msm_accumulator: Optional[MsmAccumulator] = None,
           rand: Optional[Rand] = None) -> bool:
    """samescalarargument.go:83-100 — eager in the reference (the only
    non-accumulated sub-verifier, 8 scalar-mults). When an accumulator is
    supplied, the four point identities defer into the verifier's one MSM
    as linear combinations instead (the path curdleproof.verify takes);
    standalone callers keep the eager reference behavior."""
    transcript.append_points(LABEL_POINTS, R, S, T.t1, T.t2, U.t1, U.t2,
                             proof.a.t1, proof.a.t2, proof.b.t1, proof.b.t2)
    alpha = transcript.get_and_append_challenge(LABEL_ALPHA)

    if msm_accumulator is not None:
        # A + alpha*T == com(z_k*R, z_t), B + alpha*U == com(z_k*S, z_u):
        #   t1 legs:  a.t1 + alpha*T.t1 == z_t*G_t   (resp. z_u*G_u)
        #   t2 legs:  a.t2 + alpha*T.t2 == z_k*R + z_t*H
        msm_accumulator.accumulate_check(
            [(proof.a.t1, 1), (T.t1, alpha)], [proof.z_t], [crs.gt], rand)
        msm_accumulator.accumulate_check(
            [(proof.a.t2, 1), (T.t2, alpha)],
            [proof.z_k, proof.z_t], [R, crs.h], rand)
        msm_accumulator.accumulate_check(
            [(proof.b.t1, 1), (U.t1, alpha)], [proof.z_u], [crs.gu], rand)
        msm_accumulator.accumulate_check(
            [(proof.b.t2, 1), (U.t2, alpha)],
            [proof.z_k, proof.z_u], [S, crs.h], rand)
        return True

    expected_1 = GroupCommitment.new(crs.gt, crs.h,
                                     fh.g1_mul(R, proof.z_k), proof.z_t)
    expected_2 = GroupCommitment.new(crs.gu, crs.h,
                                     fh.g1_mul(S, proof.z_k), proof.z_u)
    return (proof.a.add(T.mul(alpha)).eq(expected_1)
            and proof.b.add(U.mul(alpha)).eq(expected_2))
