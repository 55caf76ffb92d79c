"""Host-side BLS12-381 arithmetic over Python ints.

The port's own copy of go_curdleproofs_tpu/utils/field_host.py: the exact
bignum oracle, used for

  * protocol scalar (Fr) arithmetic, a negligible share of the run time
    (SURVEY.md section 2.2), which stays on the host;
  * serialization boundaries (canonicalization, compression decisions);
  * the few single-point group operations of the protocol, and the oracle
    that the tests hold the device code against.

The torch ops and CUDA kernels in go_curdleproofs_tpu_torch/ops are the
compute path; everything here is O(protocol-size), not O(msm-size). The
group operations take the host C library when there is one
(utils/native.py) and Python bignums otherwise.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

from . import native

# BLS12-381 base field and scalar field moduli.
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

B_COEFF = 4  # curve: y^2 = x^3 + 4

# G1 generator (affine), from the BLS12-381 spec.
G1_GEN_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_GEN_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

Affine = Optional[Tuple[int, int]]  # None == point at infinity
G1_GEN: Affine = (G1_GEN_X, G1_GEN_Y)


def _pt96(pt: Tuple[int, int]) -> bytes:
    return pt[0].to_bytes(48, "big") + pt[1].to_bytes(48, "big")


def _pt_from96(raw: bytes) -> Tuple[int, int]:
    return (int.from_bytes(raw[:48], "big"), int.from_bytes(raw[48:96], "big"))


# -- Fr / Fp helpers --------------------------------------------------------

def fr_add(a: int, b: int) -> int:
    return (a + b) % R


def fr_sub(a: int, b: int) -> int:
    return (a - b) % R


def fr_mul(a: int, b: int) -> int:
    return (a * b) % R


def fr_neg(a: int) -> int:
    return (-a) % R


def fr_inv(a: int) -> int:
    if a % R == 0:
        raise ZeroDivisionError("Fr inverse of zero")
    return pow(a, -1, R)


def fr_batch_inv(xs: List[int]) -> List[int]:
    """Montgomery's trick; zero entries are not allowed."""
    n = len(xs)
    if n == 0:
        return []
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % R
    inv_all = fr_inv(prefix[n])
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % R
        inv_all = inv_all * xs[i] % R
    return out


def fr_inner_product(a: List[int], b: List[int]) -> int:
    """<a, b> mod r. Mirrors common.IPA (common/util.go:26 of the Go reference)."""
    if len(a) != len(b):
        raise ValueError("IPA: len(a) != len(b)")
    return sum(x * y for x, y in zip(a, b)) % R


def fp_inv(a: int) -> int:
    return pow(a, -1, P)


def fp_sqrt(a: int) -> Optional[int]:
    """Square root in Fp (p ≡ 3 mod 4), or None if a is not a QR."""
    a %= P
    cand = pow(a, (P + 1) // 4, P)
    if cand * cand % P == a:
        return cand
    return None


def fp_lexicographically_largest(y: int) -> bool:
    """gnark's LexicographicallyLargest: y > (p-1)/2."""
    return y > (P - 1) // 2


# -- G1 affine group law (host oracle) --------------------------------------

def g1_is_on_curve(pt: Affine) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + B_COEFF)) % P == 0


def g1_neg(pt: Affine) -> Affine:
    if pt is None:
        return None
    return (pt[0], (-pt[1]) % P)


def g1_add(p1: Affine, p2: Affine) -> Affine:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    nat = native.lib()
    if nat is not None:
        out = ctypes.create_string_buffer(96)
        if nat.g1_add_host(_pt96(p1), 0, _pt96(p2), 0, out):
            return None
        return _pt_from96(out.raw)
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        # doubling
        lam = (3 * x1 * x1) * fp_inv(2 * y1) % P
    else:
        lam = (y2 - y1) * fp_inv(x2 - x1) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_sub(p1: Affine, p2: Affine) -> Affine:
    return g1_add(p1, g1_neg(p2))


# Jacobian coordinates (X/Z^2, Y/Z^3) for inversion-free host scalar mult.
_JacP = Tuple[int, int, int]  # Z == 0 encodes infinity


def _jac_from_affine(pt: Affine) -> _JacP:
    if pt is None:
        return (1, 1, 0)
    return (pt[0], pt[1], 1)


def _jac_to_affine(p: _JacP) -> Affine:
    x, y, z = p
    if z == 0:
        return None
    zinv = fp_inv(z)
    zinv2 = zinv * zinv % P
    return (x * zinv2 % P, y * zinv2 % P * zinv % P)


def _jac_double(p: _JacP) -> _JacP:
    x, y, z = p
    if z == 0 or y == 0:
        return (1, 1, 0)
    a = x * x % P
    b = y * y % P
    c = b * b % P
    d = 2 * ((x + b) * (x + b) - a - c) % P
    e = 3 * a % P
    f = e * e % P
    x3 = (f - 2 * d) % P
    y3 = (e * (d - x3) - 8 * c) % P
    z3 = 2 * y * z % P
    return (x3, y3, z3)


def _jac_add_affine(p: _JacP, q: Affine) -> _JacP:
    if q is None:
        return p
    x1, y1, z1 = p
    if z1 == 0:
        return _jac_from_affine(q)
    x2, y2 = q
    z1z1 = z1 * z1 % P
    u2 = x2 * z1z1 % P
    s2 = y2 * z1 % P * z1z1 % P
    h = (u2 - x1) % P
    rr = (s2 - y1) % P
    if h == 0:
        if rr == 0:
            return _jac_double(p)
        return (1, 1, 0)
    hh = h * h % P
    hhh = h * hh % P
    v = x1 * hh % P
    x3 = (rr * rr - hhh - 2 * v) % P
    y3 = (rr * (v - x3) - y1 * hhh) % P
    z3 = z1 * h % P
    return (x3, y3, z3)


def g1_mul(pt: Affine, k: int) -> Affine:
    """Scalar multiplication by a non-negative integer (not reduced mod r)."""
    if k < 0:
        raise ValueError("negative scalar")
    if pt is None or k == 0:
        return None
    nat = native.lib()
    if nat is not None:
        kb = k.to_bytes(max(32, (k.bit_length() + 7) // 8), "big")
        out = ctypes.create_string_buffer(96)
        if nat.g1_mul_host(_pt96(pt), 0, kb, len(kb), out):
            return None
        return _pt_from96(out.raw)
    acc: _JacP = (1, 1, 0)
    for bit in bin(k)[2:]:
        acc = _jac_double(acc)
        if bit == "1":
            acc = _jac_add_affine(acc, pt)
    return _jac_to_affine(acc)


def g1_combine_windows(windows: List[Affine], window_bits: int = 4) -> Affine:
    """Horner-combine MSB-first window sums: acc = 2^w_bits * acc + S_w.

    The serial tail of a windowed MSM on single points; the tests' oracle
    for the `windowed_combine` kernel. One C call when the host library is
    there, Python Jacobian bignums otherwise."""
    nat = native.lib()
    if nat is not None:
        m = len(windows)
        buf = bytearray(96 * m)
        infs = bytearray(m)
        for i, w in enumerate(windows):
            if w is None:
                infs[i] = 1
            else:
                buf[96 * i:96 * (i + 1)] = _pt96(w)
        out = ctypes.create_string_buffer(96)
        if nat.g1_combine_windows_host(bytes(buf), bytes(infs), m,
                                        window_bits, out):
            return None
        return _pt_from96(out.raw)
    acc: _JacP = (1, 1, 0)
    for w in windows:
        for _ in range(window_bits):
            acc = _jac_double(acc)
        acc = _jac_add_affine(acc, w)
    return _jac_to_affine(acc)


def fp_batch_inv(vals: List[int]) -> List[int]:
    """Montgomery batch inversion: one fp_inv for the whole list (zeros map
    to zero, matching gnark's BatchInvert convention)."""
    n = len(vals)
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * (v if v else 1) % P
    inv = fp_inv(prefix[n])
    out = [0] * n
    for i in range(n - 1, -1, -1):
        v = vals[i]
        if v:
            out[i] = prefix[i] * inv % P
            inv = inv * v % P
    return out


def g1_msm(points: List[Affine], scalars: List[int]) -> Affine:
    acc: Affine = None
    for pt, s in zip(points, scalars):
        acc = g1_add(acc, g1_mul(pt, s % R))
    return acc


def g1_in_subgroup(pt: Affine) -> bool:
    if pt is None:
        return True
    if not g1_is_on_curve(pt):
        return False
    return g1_mul(pt, R) is None
