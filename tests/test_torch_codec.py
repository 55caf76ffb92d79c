"""The port's batched point decoder (go_curdleproofs_tpu_torch/ops/
codec_batch.py) against the JAX package's and the host codec: the same
points, and the same ValueError for each malformed input."""

import numpy as np
import pytest
import torch

from go_curdleproofs_tpu.ops import codec_batch as jcodec_batch
from go_curdleproofs_tpu.utils import codec as hcodec
from go_curdleproofs_tpu.utils import field_host as fh
from go_curdleproofs_tpu_torch.ops import codec_batch, fp
from go_curdleproofs_tpu_torch.utils import codec

torch.set_num_threads(1)
CPU = torch.device("cpu")
P = fh.P


def _pts(rng, n):
    return [fh.g1_mul(fh.G1_GEN, int.from_bytes(rng.bytes(32), "little")
                      % (fh.R - 1) + 1) for _ in range(n)]


def _off_subgroup_point(rng):
    """An on-curve point outside the prime-order subgroup
    (tests/test_glv.py:47-67)."""
    while True:
        x = int.from_bytes(rng.bytes(48), "little") % P
        rhs = (x * x % P * x + 4) % P
        y = pow(rhs, (P + 1) // 4, P)
        if y * y % P == rhs and fh.g1_mul((x, y), fh.R) is not None:
            return (x, y)


def _off_curve_blob(rng):
    """A canonical compressed x whose x^3 + 4 has no square root."""
    while True:
        x = int.from_bytes(rng.bytes(48), "little") % P
        rhs = (x * x % P * x + 4) % P
        if pow(rhs, (P - 1) // 2, P) == P - 1:
            b = bytearray(x.to_bytes(48, "big"))
            b[0] |= 0x80
            return bytes(b)


def test_decompress_matches_jax_and_host():
    rng = np.random.default_rng(1)
    pts = _pts(rng, 6) + [None]     # 7 x lanes: one 8-lane decode program
    blobs = [hcodec.g1_to_bytes(p) for p in pts]
    blobs.append(blobs[0])                                  # a duplicate
    got = codec_batch.batch_decompress(blobs, device=CPU)
    assert got == pts + [pts[0]]
    assert got == jcodec_batch.batch_decompress(blobs)
    assert got == [hcodec.g1_from_bytes(b) for b in blobs]
    # both y signs were exercised
    assert {fh.fp_lexicographically_largest(p[1]) for p in pts[:-1]} == {
        True, False}


def _bad_blobs():
    rng = np.random.default_rng(2)
    good = hcodec.g1_to_bytes(_pts(rng, 1)[0])
    p_bytes = bytearray(P.to_bytes(48, "big"))
    p_bytes[0] |= 0x80
    inf_bad = bytearray(48)
    inf_bad[0] = 0xC0
    inf_bad[47] = 1
    return {
        "bad_flags": bytes([good[0] & 0x1F]) + good[1:],
        "short": good[:40],
        "bad_infinity": bytes(inf_bad),
        "non_canonical_x": bytes(p_bytes),
        "off_curve": _off_curve_blob(rng),
        "off_subgroup": hcodec.g1_to_bytes(_off_subgroup_point(rng)),
    }, good


@pytest.mark.parametrize("case", ["bad_flags", "short", "bad_infinity",
                                  "non_canonical_x", "off_curve",
                                  "off_subgroup"])
def test_decompress_rejects_like_jax(case):
    bad, good = _bad_blobs()
    blobs = [good, bad[case]]
    with pytest.raises(ValueError) as port_err:
        codec_batch.batch_decompress(blobs, device=CPU)
    with pytest.raises(ValueError) as jax_err:
        jcodec_batch.batch_decompress(blobs)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError):
        hcodec.g1_from_bytes(bad[case])


def test_off_subgroup_decodes_without_the_check():
    rng = np.random.default_rng(3)
    pt = _off_subgroup_point(rng)
    blob = hcodec.g1_to_bytes(pt)
    assert codec_batch.batch_decompress([blob], device=CPU,
                                        subgroup_check=False) == [pt]


def test_subgroup_check_matches_jax():
    rng = np.random.default_rng(11)
    good = _pts(rng, 4)
    bad = _off_subgroup_point(rng)
    for pts in (good, good + [bad], [bad], [None]):
        got = codec_batch.batch_subgroup_check(pts, device=CPU)
        assert got == jcodec_batch.batch_subgroup_check(pts)
        assert got == all(fh.g1_in_subgroup(p) for p in pts)


def test_decode_pool_resolves_through_port():
    rng = np.random.default_rng(4)
    pts = _pts(rng, 3)
    pool = codec.DecodePool(CPU)
    lazy = [pool.add(hcodec.g1_to_bytes(p)) for p in pts]
    lazy.append(pool.add(hcodec.g1_to_bytes(None)))
    assert [lp.resolve() for lp in lazy] == pts + [None]
    with pytest.raises(ValueError):
        pool.add(hcodec.g1_to_bytes(_pts(rng, 1)[0]))   # already resolved


def _blob_of(pt, largest=None):
    """The compressed bytes of pt; `largest` forces the sign flag (the
    other root's bytes when it disagrees with pt's y)."""
    b = bytearray(hcodec.g1_to_bytes(pt))
    if largest is not None and pt is not None:
        b[0] = (b[0] & 0x1F) | (0xA0 if largest else 0x80)
    return bytes(b)


def _both_ways(blobs, **kw):
    """The port's result or error message, checked equal to the JAX
    package's and, point by point, to the host codec's."""
    try:
        got = codec_batch.batch_decompress(blobs, device=CPU, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as jax_err:
            jcodec_batch.batch_decompress(blobs, **kw)
        assert str(e) == str(jax_err.value)
        return str(e)
    assert got == jcodec_batch.batch_decompress(blobs, **kw)
    assert got == [hcodec.g1_from_bytes(b, **kw) for b in blobs]
    return got


@pytest.mark.parametrize("n", [1, 5, 7])
def test_decompress_any_count_both_signs(n):
    """No padding to a power of two: 1, 5 and 7 points, each y taken with
    both sign flags (the two roots of one x)."""
    rng = np.random.default_rng(20 + n)
    pts = _pts(rng, n)
    for largest in (False, True):
        got = _both_ways([_blob_of(p, largest) for p in pts])
        assert [g[0] for g in got] == [p[0] for p in pts]
        assert all(fh.fp_lexicographically_largest(g[1]) == largest
                   for g in got)


def test_decompress_infinity_and_duplicates():
    rng = np.random.default_rng(31)
    pts = _pts(rng, 3)
    blobs = [_blob_of(None), _blob_of(pts[0]), _blob_of(pts[1]),
             _blob_of(pts[0]), _blob_of(None), _blob_of(pts[2])]
    assert _both_ways(blobs) == [None, pts[0], pts[1], pts[0], None, pts[2]]
    assert _both_ways([_blob_of(None)] * 2) == [None, None]


@pytest.mark.parametrize("order", ["curve_first", "subgroup_first"])
def test_off_curve_wins_over_off_subgroup(order):
    """A batch with a point off the curve and one on the curve outside the
    subgroup raises the on-curve error, whatever their order, with and
    without the subgroup check."""
    rng = np.random.default_rng(41)
    good = [_blob_of(p) for p in _pts(rng, 3)]
    off_curve = _off_curve_blob(rng)
    off_sub = _blob_of(_off_subgroup_point(rng))
    bad = [off_curve, off_sub] if order == "curve_first" else [off_sub,
                                                                off_curve]
    blobs = good[:1] + bad[:1] + good[1:] + bad[1:]
    assert _both_ways(blobs) == "point not on curve"
    assert _both_ways(blobs, subgroup_check=False) == "point not on curve"


def test_order_three_point_is_outside_the_subgroup():
    """(0, +-2) is on the curve with order 3: the subgroup test rejects it,
    and without the check both signs decode."""
    rng = np.random.default_rng(43)
    good = [_blob_of(p) for p in _pts(rng, 2)]
    for y in (2, P - 2):
        blob = _blob_of((0, y))
        assert _both_ways(good + [blob]) == \
            "point not in prime-order subgroup"
        assert _both_ways(good + [blob], subgroup_check=False)[-1] == (0, y)


def test_decode_points_flags_and_words():
    """The plain route of `decode_points` on a mixed batch: canonical y
    words and the flags of each kind of point, against the host."""
    from go_curdleproofs_tpu_torch.ops import kernels
    rng = np.random.default_rng(47)
    pts = _pts(rng, 3) + [_off_subgroup_point(rng), (0, 2)]
    blobs = [_blob_of(p) for p in pts] + [_off_curve_blob(rng)]
    xb = torch.tensor([[b[0] & 0x1F, *b[1:48]] for b in blobs],
                      dtype=torch.uint8)
    wl = torch.tensor([b[0] >> 5 == 0b101 for b in blobs], dtype=torch.uint8)
    out, planes = kernels.decode_points(xb, wl)
    assert out.shape == (6, kernels.DECODE_WORDS) and out.dtype == torch.int32
    words = out.numpy()
    assert list(words[:, 12]) == [3, 3, 3, 1, 1, 0]
    for row, p in zip(words, pts):
        assert int.from_bytes(row[:12].tobytes(), "little") == p[1]
    assert planes.shape == (3, 6, 12) and planes.dtype == torch.int32
    assert [fp.to_ints(t)[:5] for t in planes] == [
        [p[0] for p in pts], [p[1] for p in pts], [1] * 5]
    assert kernels.decode_slots(6) == 8 and kernels.decode_slots(8) == 8


def test_decompress_is_one_wrapper_call(monkeypatch):
    """One `decode_points` wrapper call a decode, and no other kernel
    wrapper, whatever the batch."""
    from go_curdleproofs_tpu_torch.ops import kernels
    calls = []
    for name in kernels.KERNEL_NAMES:
        fn = getattr(kernels, name)
        monkeypatch.setattr(kernels, name, lambda *a, _n=name, _f=fn, **k:
                            calls.append(_n) or _f(*a, **k))
    rng = np.random.default_rng(53)
    pts = _pts(rng, 5)
    assert codec_batch.batch_decompress(
        [_blob_of(p) for p in pts], device=CPU) == pts
    assert calls == ["decode_points"]
