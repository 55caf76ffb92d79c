"""BLS12-381 G1 over Python ints: the plain reference's group arithmetic.

Written for the benchmark and independent of the program: Jacobian
coordinates for the curve y^2 = x^3 + 4 over Fp, a double-and-add scalar
multiplication, the ZCash compressed encoding (gnark's SetBytes: flags,
canonical x, square root, subgroup check) and a bucket (Pippenger) MSM.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
B = 4
# |x| of the curve's seed x = -0xd201000000010000 (r = x^4 - x^2 + 1)
SEED_ABS = 0xD201000000010000

G_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

Affine = Optional[Tuple[int, int]]      # None is the point at infinity
Jac = Tuple[int, int, int]              # Z == 0 is the point at infinity
G: Affine = (G_X, G_Y)
INF: Jac = (1, 1, 0)

_FLAG_MASK = 0xE0
_SMALLEST = 0x80
_LARGEST = 0xA0
_INFINITY = 0xC0


# -- group law in Jacobian coordinates (a = 0) --------------------------------

def to_jac(p: Affine) -> Jac:
    return INF if p is None else (p[0], p[1], 1)


def to_affine(p: Jac) -> Affine:
    x, y, z = p
    if z == 0:
        return None
    zi = pow(z, -1, P)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 * zi % P)


def dbl(p: Jac) -> Jac:
    x, y, z = p
    if z == 0 or y == 0:
        return INF
    a = x * x % P
    b = y * y % P
    c = b * b % P
    d = 2 * ((x + b) * (x + b) - a - c) % P
    e = 3 * a % P
    x3 = (e * e - 2 * d) % P
    return (x3, (e * (d - x3) - 8 * c) % P, 2 * y * z % P)


def add_affine(p: Jac, q: Affine) -> Jac:
    """p + q for an affine q (mixed addition)."""
    if q is None:
        return p
    x1, y1, z1 = p
    if z1 == 0:
        return (q[0], q[1], 1)
    z1z1 = z1 * z1 % P
    h = (q[0] * z1z1 - x1) % P
    rr = (q[1] * z1 * z1z1 - y1) % P
    if h == 0:
        return dbl(p) if rr == 0 else INF
    hh = h * h % P
    hhh = h * hh % P
    v = x1 * hh % P
    x3 = (rr * rr - hhh - 2 * v) % P
    return (x3, (rr * (v - x3) - y1 * hhh) % P, z1 * h % P)


def add(p: Jac, q: Jac) -> Jac:
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 * z2z2 % P
    s2 = y2 * z1 * z1z1 % P
    h = (u2 - u1) % P
    rr = (s2 - s1) % P
    if h == 0:
        return dbl(p) if rr == 0 else INF
    hh = h * h % P
    hhh = h * hh % P
    v = u1 * hh % P
    x3 = (rr * rr - hhh - 2 * v) % P
    return (x3, (rr * (v - x3) - s1 * hhh) % P, z1 * z2 * h % P)


def neg(p: Affine) -> Affine:
    return None if p is None else (p[0], (-p[1]) % P)


def mul_jac(p: Jac, k: int) -> Jac:
    """k * p for k >= 0, most significant bit first."""
    acc = INF
    for bit in bin(k)[2:] if k > 0 else "":
        acc = dbl(acc)
        if bit == "1":
            acc = add(acc, p)
    return acc


def mul(p: Affine, k: int) -> Affine:
    """k * p for an affine p and any integer k (reduced mod r first)."""
    k %= R
    if p is None or k == 0:
        return None
    acc = INF
    for bit in bin(k)[2:]:
        acc = dbl(acc)
        if bit == "1":
            acc = add_affine(acc, p)
    return to_affine(acc)


def add_points(*pts: Affine) -> Affine:
    acc = INF
    for q in pts:
        acc = add_affine(acc, q)
    return to_affine(acc)


def on_curve(p: Affine) -> bool:
    return p is None or (p[1] * p[1] - p[0] ** 3 - B) % P == 0


# -- subgroup membership ----------------------------------------------------------
# gnark-crypto's G1Jac.IsInSubGroup for BLS12-381, which the Go reference's
# decoder runs: P is in the order-r subgroup iff P + x^2 * phi(P) is the
# identity, phi(x, y) = (beta * x, y) with beta the cube root of unity in Fp
# whose eigenvalue on the subgroup makes the generator pass. The tests hold
# it against r * P == O on points in and out of the subgroup.

def _cube_roots_of_unity() -> List[int]:
    s = pow(P - 3, (P + 1) // 4, P)           # sqrt(-3); p = 3 mod 4
    half = pow(2, -1, P)
    return [(-1 + s) * half % P, (-1 - s) * half % P]


def _passes(p: Affine, beta: int) -> bool:
    phi = (beta * p[0] % P, p[1])
    q = mul_jac(mul_jac(to_jac(phi), SEED_ABS), SEED_ABS)
    return add_affine(q, p)[2] == 0


BETA = next(b for b in _cube_roots_of_unity() if _passes(G, b))


def in_subgroup(p: Affine) -> bool:
    return p is None or (on_curve(p) and _passes(p, BETA))


def in_subgroup_by_order(p: Affine) -> bool:
    """r * P == O: the definition, slower; the tests' witness."""
    return p is None or (on_curve(p) and mul_jac(to_jac(p), R)[2] == 0)


# -- ZCash compressed encoding ------------------------------------------------------

def encode(p: Affine) -> bytes:
    if p is None:
        return bytes([_INFINITY]) + bytes(47)
    out = bytearray(p[0].to_bytes(48, "big"))
    out[0] |= _LARGEST if p[1] > (P - 1) // 2 else _SMALLEST
    return bytes(out)


def decode(blob: bytes) -> Affine:
    """A 48-byte compressed point with every check of gnark's SetBytes;
    ValueError on anything else."""
    if len(blob) != 48:
        raise ValueError("a compressed point is 48 bytes")
    flags = blob[0] & _FLAG_MASK
    rest = bytes([blob[0] & ~_FLAG_MASK & 0xFF]) + blob[1:]
    if flags == _INFINITY:
        if any(rest):
            raise ValueError("invalid infinity encoding")
        return None
    if flags not in (_SMALLEST, _LARGEST):
        raise ValueError("invalid point flags")
    x = int.from_bytes(rest, "big")
    if x >= P:
        raise ValueError("x not canonical")
    rhs = (x * x * x + B) % P
    y = pow(rhs, (P + 1) // 4, P)
    if y * y % P != rhs:
        raise ValueError("not on the curve")
    if (y > (P - 1) // 2) != (flags == _LARGEST):
        y = P - y
    pt = (x, y)
    if not in_subgroup(pt):
        raise ValueError("not in the prime-order subgroup")
    return pt


class Decoder:
    """Memoised decode: a blob is decoded once per process."""

    def __init__(self):
        self._memo: Dict[bytes, Affine] = {}

    def __call__(self, blob: bytes) -> Affine:
        blob = bytes(blob)
        if blob not in self._memo:
            self._memo[blob] = decode(blob)
        return self._memo[blob]


# -- multi-scalar multiplication -------------------------------------------------------

def msm(points: Sequence[Affine], scalars: Sequence[int]) -> Jac:
    """sum scalars[i] * points[i] by buckets of c-bit windows."""
    pairs = [(p, s % R) for p, s in zip(points, scalars)
             if p is not None and s % R]
    if not pairs:
        return INF
    c = max(2, min(12, len(pairs).bit_length() - 2))
    windows = (R.bit_length() + c - 1) // c
    mask = (1 << c) - 1
    total = INF
    for w in range(windows - 1, -1, -1):
        for _ in range(c):
            total = dbl(total)
        buckets: List[Jac] = [INF] * (1 << c)
        shift = w * c
        for p, s in pairs:
            d = (s >> shift) & mask
            if d:
                buckets[d] = add_affine(buckets[d], p)
        running = INF
        window_sum = INF
        for d in range(mask, 0, -1):
            running = add(running, buckets[d])
            window_sum = add(window_sum, running)
        total = add(total, window_sum)
    return total
