"""The least device work of a request, from its sizes alone, and the card's
peaks. Frozen with the benchmark: the same request reads the same work
whatever implements it, so a kernel's share of this bound moves only with
its time.

Work is counted in 32-bit multiply-adds (MACs) and bytes:

* an Fp product, schoolbook 12 x 12 words and a Montgomery reduction,
  2 x 144 MACs; a square 78 + 144;
* a point addition at its cheapest, affine with its inversion shared over
  a batch (Montgomery's trick, 3 products a point): 5 products and a
  square; a doubling 5 products and 2 squares;
* a decode: the square-root ladder for (p+1)/4 (at least as many steps as
  the exponent has bits less one), the curve equation, the root's check,
  and the subgroup check P + x^2 * phi(P) = O (phi one product, x^2 of
  128 bits at least 127 doublings); 48 bytes in, 96 out;
* an MSM of m pairs of 255-bit scalars: GLV halves, 2m pairs of 128-bit
  scalars, then the cheaper of Pippenger with signed c-bit digits at its
  best c (2m additions into 2^(c-1) buckets and 2^c to sum them, a
  window) and Straus with width-w NAF at its best w, plus 127 doublings;
  96 + 32 bytes a pair in, 96 out.

The peaks of one H100 SXM: 132 SMs x 64 INT32 lanes x 1.98 GHz boost =
16.73e12 MACs a second (derived; NVIDIA publishes no integer
multiply-add rate for these units), and 3.35e12 bytes a second of HBM3
(the data sheet).
"""

from __future__ import annotations

from typing import Dict, Iterable

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

FP_MUL = 2 * 144
FP_SQR = 78 + 144
ADD = 5 * FP_MUL + FP_SQR
DBL = 5 * FP_MUL + 2 * FP_SQR
HALF_BITS = 128                          # a GLV half of a 255-bit scalar
SQRT_STEPS = ((P + 1) // 4).bit_length() - 1
DECODE_MACS = (SQRT_STEPS * FP_SQR + FP_SQR + FP_MUL + FP_SQR
               + FP_MUL + (HALF_BITS - 1) * DBL)
DECODE_BYTES = 48 + 96

PEAK_MACS_PER_S = 132 * 64 * 1.98e9
PEAK_BYTES_PER_S = 3.35e12


def msm_additions(m: int) -> int:
    """The fewest additions of either method for m pairs."""
    lanes = 2 * m
    pippenger = min(-(-HALF_BITS // c) * (lanes + (1 << c))
                    for c in range(1, 25))
    straus = min(lanes * (-(-HALF_BITS // (w + 1)) + (1 << (w - 2)))
                 for w in range(2, 12))
    return min(pippenger, straus)


def msm_macs(m: int) -> int:
    return msm_additions(m) * ADD + (HALF_BITS - 1) * DBL


def work_macs_bytes(work: Dict) -> tuple:
    """(MACs, bytes) of {"decode": points, "msm": [pairs, ...]}."""
    msms: Iterable[int] = work.get("msm", [])
    macs = work.get("decode", 0) * DECODE_MACS
    nbytes = work.get("decode", 0) * DECODE_BYTES
    for m in msms:
        macs += msm_macs(m)
        nbytes += m * (96 + 32) + 96
    return macs, nbytes


def bound_seconds(work: Dict) -> float:
    macs, nbytes = work_macs_bytes(work)
    return max(macs / PEAK_MACS_PER_S, nbytes / PEAK_BYTES_PER_S)


def proof_points(ell: int) -> int:
    """Points on the wire in a shuffle proof of ell trackers: M; A, T, U,
    R, S; B; C; B_c, B_d and four IPA lists; the same-scalar A, B; B_a,
    B_t, B_u and six same-msm lists, log2(ell + 4) points a list."""
    rounds = (ell + 4).bit_length() - 1
    return 19 + 10 * rounds


def verify_msm_bases(ell: int, trackers: int, proofs: int = 1) -> int:
    """Bases of the verifier's one final MSM: the CRS row Gs|Hs, H, G_t,
    G_u; the distinct tracker points; every proof point; and per proof the
    two points the verifier forms (A' of the same-msm step, D of the grand
    product)."""
    return (ell + 4) + 3 + trackers + proofs * (proof_points(ell) + 2)


def prove_work(ell: int) -> Dict:
    """The host prover's device work: decode the 2 ell pre-tracker points,
    2 ell scalar multiplications for the shuffle, and its MSMs: M, A, C and
    D over the row of n = ell + 4, the IPA's B_c, B_d and four cross terms
    a round over the half, R and S over ell, the same-msm B_a, B_t, B_u and
    six cross terms a round over the half."""
    n = ell + 4
    halves = []
    h = n // 2
    while h >= 1:
        halves.append(h)
        h //= 2
    msm = [n] * 6 + [ell] * 2 + [n] * 3
    msm += [h for h in halves for _ in range(4 + 6)]
    msm += [1] * (2 * ell)
    return {"decode": 2 * ell, "msm": msm}
