"""Pedersen commitment to a group element.

The port's own copy of go_curdleproofs_tpu/models/group_commitment.py
(groupcommitment/groupcommitment.go of the Go reference):
  (T_1, T_2) = (r*G, T + r*H), homomorphic Add/Mul, 96-byte serialization.
Host group operations only: no device call.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import BinaryIO

from ..utils import codec
from ..utils import field_host as fh
from ..utils.field_host import Affine


@dataclass
class GroupCommitment:
    t1: Affine
    t2: Affine

    @classmethod
    def new(cls, crs_g: Affine, crs_h: Affine, t: Affine,
            r: int) -> "GroupCommitment":
        return cls(fh.g1_mul(crs_g, r % fh.R),
                   fh.g1_add(t, fh.g1_mul(crs_h, r % fh.R)))

    def add(self, other: "GroupCommitment") -> "GroupCommitment":
        return GroupCommitment(fh.g1_add(self.t1, other.t1),
                               fh.g1_add(self.t2, other.t2))

    def mul(self, scalar: int) -> "GroupCommitment":
        s = scalar % fh.R
        return GroupCommitment(fh.g1_mul(self.t1, s), fh.g1_mul(self.t2, s))

    def eq(self, other: "GroupCommitment") -> bool:
        return self.t1 == other.t1 and self.t2 == other.t2

    def serialize(self, w: BinaryIO) -> None:
        e = codec.Encoder(w)
        e.write_point(self.t1)
        e.write_point(self.t2)

    @classmethod
    def from_reader(cls, r: BinaryIO) -> "GroupCommitment":
        d = codec.Decoder(r)
        return cls(d.read_point(), d.read_point())
