"""A plain Curdleproofs / Whisk shuffle verifier and shuffle check.

Follows the Go reference (crs.go, curdleproof.go and its sub-arguments:
samepermutationargument.go, grandproductargument.go,
innerproductargument.go, samescalarargument.go,
samemultiscalarargument.go; whisk/whisk.go) over bls.py, transcript.py and
rand.py. Every point is decoded from its bytes with the full checks; every
group identity the verifier defers is folded with a random weight into one
sum of scalar multiples that must be the identity, as the Go reference's
MSM accumulator does.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

from . import bls
from .bls import R, Affine
from .rand import Rand
from .transcript import Transcript

N_BLINDERS = 4
MAX_RECURSIVE_STEPS = 32
Tracker = Tuple[bytes, bytes]          # (r*G, k*r*G), compressed


@dataclass
class CRS:
    gs: List[Affine]
    hs: List[Affine]
    h: Affine
    gt: Affine
    gu: Affine
    gsum: Affine
    hsum: Affine


def make_crs(ell: int, seed: int) -> CRS:
    """crs.go: Gs, Hs, H, G_t, G_u as generator multiples drawn in this
    order from Rand(seed)."""
    rand = Rand(seed)
    gs = [bls.mul(bls.G, s) for s in rand.frs(ell)]
    hs = [bls.mul(bls.G, s) for s in rand.frs(N_BLINDERS)]
    h, gt, gu = (bls.mul(bls.G, s) for s in rand.frs(3))
    return CRS(gs, hs, h, gt, gu, bls.add_points(*gs), bls.add_points(*hs))


class _Reader:
    """gnark framing: compressed points, u32 big-endian list lengths,
    32-byte big-endian scalars reduced mod r. Trailing bytes are ignored
    (the fixed 4,576-byte array's padding)."""

    def __init__(self, data: bytes, decode: Callable[[bytes], Affine]):
        self.data = data
        self.pos = 0
        self.decode = decode

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("unexpected end of proof")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def point(self) -> Affine:
        return self.decode(self._take(48))

    def points(self) -> List[Affine]:
        return [self.point()
                for _ in range(int.from_bytes(self._take(4), "big"))]

    def fr(self) -> int:
        return int.from_bytes(self._take(32), "big") % R


def parse_proof(data: bytes, decode) -> Dict[str, object]:
    rd = _Reader(data, decode)
    p: Dict[str, object] = {}
    for k in ("m", "a", "t_t1", "t_t2", "u_t1", "u_t2", "r", "s", "b", "c"):
        p[k] = rd.point()
    p["r_p"] = rd.fr()
    p["b_c"], p["b_d"] = rd.point(), rd.point()
    for k in ("l_cs", "r_cs", "l_ds", "r_ds"):
        p[k] = rd.points()
    p["c0"], p["d0"] = rd.fr(), rd.fr()
    for k in ("ss_a1", "ss_a2", "ss_b1", "ss_b2"):
        p[k] = rd.point()
    p["z_k"], p["z_t"], p["z_u"] = rd.fr(), rd.fr(), rd.fr()
    for k in ("b_a", "b_t", "b_u"):
        p[k] = rd.point()
    for k in ("l_a", "l_t", "l_u", "r_a", "r_t", "r_u"):
        p[k] = rd.points()
    p["x"] = rd.fr()
    return p


class Accumulator:
    """Deferred checks c == <x, v>, each weighted by a fresh random alpha,
    summed into one base -> scalar map; sound iff that sum is O."""

    def __init__(self, rng: random.Random):
        self.rng = rng
        self.terms: Dict[Tuple[int, int], int] = {}

    def _bump(self, base: Affine, scalar: int) -> None:
        if base is not None:
            self.terms[base] = (self.terms.get(base, 0) + scalar) % R

    def check(self, c: Sequence[Tuple[Affine, int]], x: Sequence[int],
              v: Sequence[Affine]) -> None:
        if len(x) != len(v):
            raise ValueError("x and v differ in length")
        alpha = self.rng.randrange(1, R)
        for xi, vi in zip(x, v):
            self._bump(vi, alpha * xi)
        for q, coeff in c:
            self._bump(q, -alpha * coeff)

    def holds(self) -> bool:
        bases = list(self.terms)
        return bls.msm(bases, [self.terms[b] for b in bases])[2] == 0


def _s_vector(challenges: List[int]) -> List[int]:
    """s[i] = prod_j challenges[j]^bit, the last challenge on bit 0."""
    s = [1]
    for g in reversed(challenges):
        s = s + [v * g % R for v in s]
    return s


def _verify_ipa(p, gs: List[Affine], h: Affine, C: Affine, D: Affine, z: int,
                us: List[int], tr: Transcript, acc: Accumulator) -> None:
    tr.append_points(b"ipa_step1", C, D)
    tr.append_scalars(b"ipa_step1", z)
    tr.append_points(b"ipa_step1", p["b_c"], p["b_d"])
    alpha = tr.challenge(b"ipa_alpha")
    beta = tr.challenge(b"ipa_beta")
    n = len(gs)
    if n & (n - 1):
        raise ValueError("ipa n is not a power of two")
    m = n.bit_length() - 1
    if min(len(p[k]) for k in ("l_cs", "r_cs", "l_ds", "r_ds")) < m:
        raise ValueError("ipa proof too short")
    gamma = []
    for i in range(m):
        tr.append_points(b"ipa_loop", p["l_cs"][i], p["l_ds"][i],
                         p["r_cs"][i], p["r_ds"][i])
        gamma.append(tr.challenge(b"ipa_gamma"))
    gamma_inv = [pow(g, -1, R) for g in gamma]
    s = _s_vector(gamma)
    s_prime = _s_vector(gamma_inv)
    c0, d0 = p["c0"], p["d0"]
    lhs1 = ([(p["b_c"], 1), (h, alpha * alpha * z * beta), (C, alpha)]
            + list(zip(p["l_cs"], gamma)) + list(zip(p["r_cs"], gamma_inv)))
    acc.check(lhs1, [si * c0 for si in s] + [beta * d0 * c0],
              list(gs) + [h])
    lhs2 = ([(p["b_d"], 1), (D, alpha)]
            + list(zip(p["l_ds"], gamma)) + list(zip(p["r_ds"], gamma_inv)))
    acc.check(lhs2, [sp * u * d0 for sp, u in zip(s_prime, us)], gs)


def _verify_grand_product(p, crs: CRS, B: Affine, result: int,
                          tr: Transcript, acc: Accumulator) -> None:
    ell = len(crs.gs)
    tr.append_points(b"gprod_step1", B)
    tr.append_scalars(b"gprod_step1", result)
    alpha = tr.challenge(b"gprod_alpha")
    tr.append_points(b"gprod_step2", p["c"])
    tr.append_scalars(b"gprod_step2", p["r_p"])
    beta = tr.challenge(b"gprod_beta")
    if beta == 0:
        raise ValueError("beta is zero")
    beta_inv = pow(beta, -1, R)
    us = [pow(beta_inv, i + 1, R) for i in range(ell)]
    us += [pow(beta_inv, ell + 1, R)] * N_BLINDERS
    D = bls.add_points(B, bls.neg(bls.mul(crs.gsum, beta_inv)),
                       bls.mul(crs.hsum, alpha))
    beta_l = pow(beta, ell, R)
    z = (p["r_p"] * beta_l * beta + result * beta_l - 1) % R
    _verify_ipa(p, list(crs.gs) + list(crs.hs), crs.h, p["c"], D, z, us,
                tr, acc)


def _verify_same_permutation(p, crs: CRS, A: Affine, M: Affine,
                             as_: List[int], tr: Transcript,
                             acc: Accumulator) -> None:
    tr.append_points(b"same_perm_step1", A, M)
    tr.append_scalars(b"same_perm_step1", *as_)
    alpha = tr.challenge(b"same_perm_alpha")
    beta = tr.challenge(b"same_perm_beta")
    prod = 1
    for i, a in enumerate(as_):
        prod = prod * (i * alpha + beta + a) % R
    acc.check([(p["b"], 1), (A, -1), (M, -alpha)], [beta] * len(crs.gs),
              crs.gs)
    _verify_grand_product(p, crs, p["b"], prod, tr, acc)


def _verify_same_scalar(p, crs: CRS, tr: Transcript, acc: Accumulator):
    tr.append_points(b"sameexp_points", p["r"], p["s"], p["t_t1"],
                     p["t_t2"], p["u_t1"], p["u_t2"], p["ss_a1"],
                     p["ss_a2"], p["ss_b1"], p["ss_b2"])
    alpha = tr.challenge(b"sameexp_alpha")
    acc.check([(p["ss_a1"], 1), (p["t_t1"], alpha)], [p["z_t"]], [crs.gt])
    acc.check([(p["ss_a2"], 1), (p["t_t2"], alpha)], [p["z_k"], p["z_t"]],
              [p["r"], crs.h])
    acc.check([(p["ss_b1"], 1), (p["u_t1"], alpha)], [p["z_u"]], [crs.gu])
    acc.check([(p["ss_b2"], 1), (p["u_t2"], alpha)], [p["z_k"], p["z_u"]],
              [p["s"], crs.h])


def _verify_same_multiscalar(p, G, A, Z_t, Z_u, T, U, tr: Transcript,
                             acc: Accumulator) -> None:
    n = len(T)
    tr.append_points(b"same_msm_step1", A, Z_t, Z_u)
    tr.append_points(b"same_msm_step1", *T)
    tr.append_points(b"same_msm_step1", *U)
    tr.append_points(b"same_msm_step1", p["b_a"], p["b_t"], p["b_u"])
    alpha = tr.challenge(b"same_msm_alpha")
    lg_n = len(p["l_a"])
    if lg_n >= MAX_RECURSIVE_STEPS or n != 1 << lg_n:
        raise ValueError("same-msm proof of the wrong length")
    if min(len(p[k]) for k in ("l_t", "l_u", "r_a", "r_t", "r_u")) < lg_n:
        raise ValueError("same-msm proof too short")
    gamma = []
    for i in range(lg_n):
        tr.append_points(b"same_msm_loop", *(p[k][i] for k in (
            "l_a", "l_t", "l_u", "r_a", "r_t", "r_u")))
        gamma.append(tr.challenge(b"same_msm_gamma"))
    gamma_inv = [pow(g, -1, R) for g in gamma]
    xs = [p["x"] * si for si in _s_vector(gamma)]
    for lead, comm, ls, rs, bases in (
            ("b_a", A, "l_a", "r_a", G), ("b_t", Z_t, "l_t", "r_t", T),
            ("b_u", Z_u, "l_u", "r_u", U)):
        lhs = ([(p[lead], 1), (comm, alpha)] + list(zip(p[ls], gamma))
               + list(zip(p[rs], gamma_inv)))
        acc.check(lhs, xs, bases)


def verify_shuffle(crs: CRS, pre: Sequence[Tracker], post: Sequence[Tracker],
                   proof: bytes, decode, rng: random.Random,
                   final_check: bool = True) -> bool:
    """whisk.go IsValidWhiskShuffleProof: False for any proof, pairing or
    encoding that does not verify. `final_check=False` skips the one sum
    that every deferred identity rides on (the control: soundness gone)."""
    try:
        if len(pre) != len(post) or len(pre) != len(crs.gs):
            return False
        p = parse_proof(proof, decode)
        Rs = [decode(t[0]) for t in pre]
        Ss = [decode(t[1]) for t in pre]
        Ts = [decode(t[0]) for t in post]
        Us = [decode(t[1]) for t in post]
        if Ts[0] is None:
            return False                     # a zero randomizer
        tr = Transcript(b"curdleproofs")
        for pts in (Rs, Ss, Ts, Us):
            tr.append_points(b"curdleproofs_step1", *pts)
        tr.append_points(b"curdleproofs_step1", p["m"])
        as_ = tr.challenges(b"curdleproofs_vec_a", len(Rs))
        acc = Accumulator(rng)
        _verify_same_permutation(p, crs, p["a"], p["m"], as_, tr, acc)
        _verify_same_scalar(p, crs, tr, acc)
        a_prime = bls.add_points(p["a"], p["t_t1"], p["u_t1"])
        G = list(crs.gs) + list(crs.hs[:N_BLINDERS - 2]) + [crs.gt, crs.gu]
        _verify_same_multiscalar(p, G, a_prime, p["t_t2"], p["u_t2"],
                                 Ts + [None, None, crs.h, None],
                                 Us + [None, None, None, crs.h], tr, acc)
        acc.check([(p["r"], 1)], as_, Rs)
        acc.check([(p["s"], 1)], as_, Ss)
        return acc.holds() if final_check else True
    except ValueError:
        return False


def shuffle_mismatches(pre: Sequence[Tracker], post: Sequence[Tracker],
                       rand_seed: int, decode) -> int:
    """whisk.go GenerateWhiskShuffleProof's shuffle: the permutation, then
    k, drawn first from the request's Rand; post[i] = k * pre[perm[i]],
    both points of each tracker. Returns the trackers that differ."""
    rand = Rand(rand_seed)
    perm = rand.permutation(len(pre))
    k = rand.fr()
    bad = 0
    for i, j in enumerate(perm):
        want = tuple(bls.encode(bls.mul(decode(b), k)) for b in pre[j])
        bad += want != tuple(bytes(b) for b in post[i])
    return bad
