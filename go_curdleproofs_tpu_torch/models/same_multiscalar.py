"""Same-multiscalar argument: Bulletproofs-style folding over three bases
(go_curdleproofs_tpu/models/same_multiscalar.py;
samemultiscalarargument.go of the Go reference): A = <x, G>, Z_t = <x, T>,
Z_u = <x, U> share x.

The prover keeps G, T, U stacked on the device as one three-row
`curve.FoldedBases`: each round's six cross-term MSMs are one `msm_many`
call and the folds are scalar-side. This prover is host-orchestrated only;
the one-fetch device prover (models/device_prover_full.py) runs the same
rounds inside its own chain (models/device_prover2.py's `run_sm_rounds`).
The verifier's three checks defer into the accumulator as linear
combinations."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import BinaryIO, List

import torch

from ..ops import curve
from ..utils import codec
from ..utils import field_host as fh
from ..utils import profiling
from ..utils.field_host import Affine
from ..utils.rand import Rand
from ..utils.transcript import Transcript
from .msm_accumulator import MsmAccumulator

LABEL_STEP1 = b"same_msm_step1"
LABEL_ALPHA = b"same_msm_alpha"
LABEL_LOOP = b"same_msm_loop"
LABEL_GAMMA = b"same_msm_gamma"

MAX_RECURSIVE_STEPS = 32


@dataclass
class Proof:
    b_a: Affine
    b_t: Affine
    b_u: Affine
    l_a: List[Affine] = field(default_factory=list)
    l_t: List[Affine] = field(default_factory=list)
    l_u: List[Affine] = field(default_factory=list)
    r_a: List[Affine] = field(default_factory=list)
    r_t: List[Affine] = field(default_factory=list)
    r_u: List[Affine] = field(default_factory=list)
    x: int = 0

    def serialize(self, w: BinaryIO) -> None:
        e = codec.Encoder(w)
        e.write_point(self.b_a)
        e.write_point(self.b_t)
        e.write_point(self.b_u)
        e.write_points(self.l_a)
        e.write_points(self.l_t)
        e.write_points(self.l_u)
        e.write_points(self.r_a)
        e.write_points(self.r_t)
        e.write_points(self.r_u)
        e.write_fr(self.x)

    @classmethod
    def from_reader(cls, r: BinaryIO) -> "Proof":
        d = codec.Decoder(r)
        return cls(d.read_point(), d.read_point(), d.read_point(),
                   d.read_points(), d.read_points(), d.read_points(),
                   d.read_points(), d.read_points(), d.read_points(),
                   d.read_fr())


@profiling.traced("same_multiscalar.prove")
def prove(G: List[Affine], A: Affine, Z_t: Affine, Z_u: Affine,
          T: List[Affine], U: List[Affine], x: List[int],
          transcript: Transcript, rand: Rand, *,
          device: torch.device) -> Proof:
    """samemultiscalarargument.go:37-157."""
    n = len(x)
    r = rand.get_frs(n)

    gtu = curve.FoldedBases.from_affine([G, T, U], device=device)
    b_a, b_t, b_u = gtu.msm_many(
        [[(0, r, 0)], [(1, r, 0)], [(2, r, 0)]])

    transcript.append_points(LABEL_STEP1, A, Z_t, Z_u)
    transcript.append_points(LABEL_STEP1, *T)
    transcript.append_points(LABEL_STEP1, *U)
    transcript.append_points(LABEL_STEP1, b_a, b_t, b_u)
    alpha = transcript.get_and_append_challenge(LABEL_ALPHA)

    x = [(ri + xi * alpha) % fh.R for ri, xi in zip(r, x)]

    l_as: List[Affine] = []
    l_ts: List[Affine] = []
    l_us: List[Affine] = []
    r_as: List[Affine] = []
    r_ts: List[Affine] = []
    r_us: List[Affine] = []

    while len(x) > 1:
        half = len(x) // 2
        x_l, x_r = x[:half], x[half:]

        # all six cross-term MSMs in one device call + one fetch
        l_a, l_t, l_u, r_a, r_t, r_u = gtu.msm_many([
            [(0, x_l, half)], [(1, x_l, half)], [(2, x_l, half)],
            [(0, x_r, 0)], [(1, x_r, 0)], [(2, x_r, 0)]])

        l_as.append(l_a)
        l_ts.append(l_t)
        l_us.append(l_u)
        r_as.append(r_a)
        r_ts.append(r_t)
        r_us.append(r_u)

        transcript.append_points(LABEL_LOOP, l_a, l_t, l_u, r_a, r_t, r_u)
        gamma = transcript.get_and_append_challenge(LABEL_GAMMA)
        if gamma == 0:
            raise ValueError("gamma is zero")
        gamma_inv = fh.fr_inv(gamma)

        x = [(xl + gamma_inv * xr) % fh.R for xl, xr in zip(x_l, x_r)]
        gtu = gtu.fold(gamma)

    return Proof(b_a, b_t, b_u, l_as, l_ts, l_us, r_as, r_ts, r_us, x[0])


def unfolded_scalars(proof: Proof, n: int, transcript: Transcript):
    """Replay the challenges; ss[i] = prod challenges[k]^bit(i)."""
    lg_n = len(proof.l_a)
    if lg_n >= MAX_RECURSIVE_STEPS:
        raise ValueError("recursive steps greater than expected")
    if n != (1 << lg_n):
        raise ValueError("must be log2(L_a)")

    challenges = []
    for i in range(lg_n):
        transcript.append_points(LABEL_LOOP, proof.l_a[i], proof.l_t[i],
                                 proof.l_u[i], proof.r_a[i], proof.r_t[i],
                                 proof.r_u[i])
        challenges.append(transcript.get_and_append_challenge(LABEL_GAMMA))

    ss = [1]
    for k in range(lg_n - 1, -1, -1):
        g = challenges[k]
        ss = ss + [x * g % fh.R for x in ss]
    return challenges, fh.fr_batch_inv(challenges), ss


@profiling.traced("same_multiscalar.verify")
def verify(proof: Proof, G: List[Affine], A: Affine, Z_t: Affine,
           Z_u: Affine, T: List[Affine], U: List[Affine],
           transcript: Transcript, msm_accumulator: MsmAccumulator,
           rand: Rand) -> bool:
    n = len(T)

    transcript.append_points(LABEL_STEP1, A, Z_t, Z_u)
    transcript.append_points(LABEL_STEP1, *T)
    transcript.append_points(LABEL_STEP1, *U)
    transcript.append_points(LABEL_STEP1, proof.b_a, proof.b_t, proof.b_u)
    alpha = transcript.get_and_append_challenge(LABEL_ALPHA)

    gamma, gamma_inv, s = unfolded_scalars(proof, n, transcript)
    xtimess = [proof.x * si % fh.R for si in s]

    lr = lambda ls, rs: list(zip(ls, gamma)) + list(zip(rs, gamma_inv))
    msm_accumulator.accumulate_check(
        [(proof.b_a, 1), (A, alpha)] + lr(proof.l_a, proof.r_a),
        xtimess, G, rand)
    msm_accumulator.accumulate_check(
        [(proof.b_t, 1), (Z_t, alpha)] + lr(proof.l_t, proof.r_t),
        xtimess, T, rand)
    msm_accumulator.accumulate_check(
        [(proof.b_u, 1), (Z_u, alpha)] + lr(proof.l_u, proof.r_u),
        xtimess, U, rand)
    return True
