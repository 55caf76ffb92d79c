"""The port's own host layer (go_curdleproofs_tpu_torch/utils, ops/glv.py)
against the JAX package's originals, on the CPU, from numpy-seeded inputs:
the same group elements, digits, challenges, random streams and wire bytes,
exactly. Every case runs twice: with the port's host C library (built from
go_curdleproofs_tpu_torch/native/ at first use) and with the Python path."""

import contextlib
import io

import numpy as np
import pytest

from go_curdleproofs_tpu.ops import glv as jglv
from go_curdleproofs_tpu.utils import codec as jcodec
from go_curdleproofs_tpu.utils import field_host as jfh
from go_curdleproofs_tpu.utils import keccak as jkeccak
from go_curdleproofs_tpu.utils.rand import Rand as JRand
from go_curdleproofs_tpu.utils.transcript import Transcript as JTranscript
from go_curdleproofs_tpu_torch.ops import glv
from go_curdleproofs_tpu_torch.utils import codec, keccak, native, strobe
from go_curdleproofs_tpu_torch.utils import field_host as fh
from go_curdleproofs_tpu_torch.utils.rand import Rand
from go_curdleproofs_tpu_torch.utils.transcript import Transcript


@pytest.fixture(params=["c_library", "python_path"])
def host_path(request):
    """Run the test body under one of the two host paths."""
    if request.param == "c_library":
        if native.lib() is None:
            pytest.skip("no host C compiler: the C library cannot be built")
        ctx = contextlib.nullcontext()
    else:
        ctx = native.disabled()
    with ctx:
        assert (native.lib() is not None) == (request.param == "c_library")
        yield request.param


def _scalars(rng, n, mod=fh.R):
    return [int.from_bytes(rng.bytes(40), "little") % mod for _ in range(n)]


def test_c_library_is_the_ports_own():
    lib = native.lib()
    if lib is None:
        pytest.skip("no host C compiler")
    assert lib._name.endswith("go_curdleproofs_tpu_torch/_build/"
                              "libcurdle_host.so")
    assert strobe.has_native_bulk() and keccak.has_native()
    with native.disabled():
        assert not strobe.has_native_bulk() and not keccak.has_native()
    assert strobe.has_native_bulk()


def test_constants_match():
    assert (fh.P, fh.R, fh.G1_GEN, fh.B_COEFF) == (jfh.P, jfh.R, jfh.G1_GEN,
                                                   jfh.B_COEFF)
    assert (glv.LAMBDA, glv.BETA, glv.NUM_WINDOWS, glv.TABLE_SIZE,
            glv.WINDOW_BITS) == (jglv.LAMBDA, jglv.BETA, jglv.NUM_WINDOWS,
                                 jglv.TABLE_SIZE, jglv.WINDOW_BITS)


def test_field_host_group_ops(host_path):
    rng = np.random.default_rng(101)
    ks = _scalars(rng, 6)
    pts = [fh.g1_mul(fh.G1_GEN, k) for k in ks]
    assert pts == [jfh.g1_mul(jfh.G1_GEN, k) for k in ks]
    assert fh.g1_mul(pts[0], 0) is None and fh.g1_mul(None, 5) is None
    with pytest.raises(ValueError):
        fh.g1_mul(pts[0], -1)
    big = ks[0] << 200                         # unreduced scalar
    assert fh.g1_mul(pts[1], big) == jfh.g1_mul(pts[1], big)
    pairs = [(pts[0], pts[1]), (pts[2], pts[2]), (pts[3], fh.g1_neg(pts[3])),
             (None, pts[4]), (pts[4], None), (None, None)]
    assert [fh.g1_add(a, b) for a, b in pairs] == \
        [jfh.g1_add(a, b) for a, b in pairs]
    assert fh.g1_add(pts[3], fh.g1_neg(pts[3])) is None
    assert fh.g1_sub(pts[0], pts[1]) == jfh.g1_sub(pts[0], pts[1])
    assert fh.g1_msm(pts, ks[::-1]) == jfh.g1_msm(pts, ks[::-1])
    wins = pts[:4] + [None] + pts[4:]
    assert fh.g1_combine_windows(wins, 4) == jfh.g1_combine_windows(wins, 4)
    assert fh.g1_combine_windows([None, None], 4) is None
    assert all(fh.g1_is_on_curve(p) and fh.g1_in_subgroup(p) for p in pts)


def test_field_host_scalar_helpers(host_path):
    rng = np.random.default_rng(102)
    xs = [x or 1 for x in _scalars(rng, 9)]
    assert fh.fr_batch_inv(xs) == jfh.fr_batch_inv(xs) == \
        [pow(x, -1, fh.R) for x in xs]
    assert fh.fr_inner_product(xs, xs[::-1]) == jfh.fr_inner_product(
        xs, xs[::-1])
    vs = _scalars(rng, 7, fh.P) + [0]
    assert fh.fp_batch_inv(vs) == jfh.fp_batch_inv(vs)
    assert fh.fp_sqrt(vs[0] * vs[0] % fh.P) in (vs[0], fh.P - vs[0])
    with pytest.raises(ZeroDivisionError):
        fh.fr_inv(0)


def test_glv_digits_match(host_path):
    rng = np.random.default_rng(103)
    vals = _scalars(rng, 12) + [0, 1, fh.R - 1, glv.LAMBDA,
                                glv.LAMBDA * 2 % fh.R]
    got = glv.scalars_to_digits_glv(vals)
    assert got.dtype == np.int32 and got.shape == (34, glv.NUM_WINDOWS)
    assert (got == jglv.scalars_to_digits_glv(vals)).all()
    assert (glv.digits_nophi(glv.LAMBDA, 3)
            == jglv.digits_nophi(jglv.LAMBDA, 3)).all()
    for s in vals[:4]:
        s1, s2 = glv.split(s)
        assert (s1 + glv.LAMBDA * s2) % fh.R == s and (s1, s2) == jglv.split(s)


def test_keccak_permutation(host_path):
    rng = np.random.default_rng(104)
    state = bytearray(rng.bytes(200))
    want = bytearray(state)
    jkeccak.f1600_py(want)
    keccak.f1600(state)
    assert state == want
    assert keccak.sha3_256(b"curdle") == jkeccak.sha3_256(b"curdle")


def _drive(transcript_cls, points, scalars):
    """A mixed sequence of appends and challenges; returns every challenge."""
    t = transcript_cls(b"host-layer-test")
    out = [t.get_and_append_challenge(b"first")]
    t.append_points(b"pts", *points)
    t.append_scalars(b"scs", *scalars)
    t.append_message(b"raw", bytes(range(200)))        # crosses a rate block
    out += t.get_and_append_challenges(b"vec", 5)
    t.append_points(b"one", points[0])                 # single-message path
    t.append_points(b"inf", None)
    t.append_scalars(b"s1", scalars[0])
    out.append(t.get_and_append_challenge(b"last"))
    return out


def test_transcript_challenges_match(host_path):
    rng = np.random.default_rng(105)
    ks = _scalars(rng, 7)
    pts = [jfh.g1_mul(jfh.G1_GEN, k) for k in ks]
    got = _drive(Transcript, pts, ks)
    assert got == _drive(JTranscript, pts, ks)
    assert all(0 <= c < fh.R for c in got) and len(set(got)) == len(got)


def test_transcript_takes_lazy_points(host_path):
    """A pooled point enters the transcript by its blob, with no decode."""
    pt = fh.g1_mul(fh.G1_GEN, 99)
    pool = codec.DecodePool(device=None)
    lazy = pool.add(codec.g1_to_bytes(pt))
    a, b = Transcript(b"t"), Transcript(b"t")
    a.append_points(b"p", lazy)
    b.append_points(b"p", pt)
    assert a.get_and_append_challenge(b"c") == b.get_and_append_challenge(b"c")
    assert not pool._done


def test_rand_streams_match(host_path):
    for seed in (0, 7, 2**63):
        r, j = Rand(seed), JRand(seed)
        assert r.get_frs(5) == j.get_frs(5)
        assert r.generate_permutation(20) == j.generate_permutation(20)
        assert r.get_fr() == j.get_fr()
        assert r.get_g1s(2) == j.get_g1s(2)
        assert r.read(100) == j.read(100)
        assert sorted(r.generate_permutation(9)) == list(range(9))


def _off_subgroup_point(rng):
    while True:
        x = int.from_bytes(rng.bytes(48), "little") % fh.P
        y = fh.fp_sqrt((x * x * x + fh.B_COEFF) % fh.P)
        if y is not None and jfh.g1_mul((x, y), fh.R) is not None:
            return (x, y)


def test_codec_round_trips(host_path):
    rng = np.random.default_rng(106)
    pts = [fh.g1_mul(fh.G1_GEN, k) for k in _scalars(rng, 5)] + [None]
    for pt in pts:
        blob = codec.g1_to_bytes(pt)
        assert blob == jcodec.g1_to_bytes(pt) and len(blob) == 48
        assert codec.g1_from_bytes(blob) == pt == jcodec.g1_from_bytes(blob)
        raw = codec.g1_to_bytes_uncompressed(pt)
        assert raw == jcodec.g1_to_bytes_uncompressed(pt)
        assert codec.g1_from_bytes(raw) == pt
    scs = _scalars(rng, 3)
    buf = io.BytesIO()
    e = codec.Encoder(buf)
    e.write_point(pts[0])
    e.write_points(pts)
    for s in scs:
        e.write_fr(s)
    jbuf = io.BytesIO()
    je = jcodec.Encoder(jbuf)
    je.write_point(pts[0])
    je.write_points(pts)
    for s in scs:
        je.write_fr(s)
    assert buf.getvalue() == jbuf.getvalue()
    d = codec.Decoder(io.BytesIO(buf.getvalue()))
    assert d.read_point() == pts[0] and d.read_points() == pts
    assert [d.read_fr() for _ in scs] == scs
    with pytest.raises(ValueError):
        d.read_fr()                                     # end of stream
    assert codec.fr_from_bytes(fh.R.to_bytes(32, "big")) == 0
    with pytest.raises(ValueError):
        codec.fr_from_bytes_canonical(fh.R.to_bytes(32, "big"))


@pytest.mark.parametrize("case", ["bad_flags", "non_canonical_x",
                                  "off_curve", "off_subgroup"])
def test_codec_rejects_like_the_reference(host_path, case):
    rng = np.random.default_rng(107)
    good = codec.g1_to_bytes(fh.g1_mul(fh.G1_GEN, 12345))
    if case == "bad_flags":
        blob = bytes([good[0] | 0xE0]) + good[1:]
    elif case == "non_canonical_x":
        pb = fh.P.to_bytes(48, "big")
        blob = bytes([0x80 | pb[0]]) + pb[1:]
    elif case == "off_curve":
        x = next(x for x in range(2, 50)
                 if fh.fp_sqrt((x ** 3 + fh.B_COEFF) % fh.P) is None)
        blob = bytes([0x80]) + x.to_bytes(48, "big")[1:]
    else:
        blob = codec.g1_to_bytes(_off_subgroup_point(rng))
    with pytest.raises(ValueError):
        codec.g1_from_bytes(blob)
    with pytest.raises(ValueError):
        jcodec.g1_from_bytes(blob)
    if case == "off_subgroup":
        assert codec.g1_from_bytes(blob, subgroup_check=False) is not None
