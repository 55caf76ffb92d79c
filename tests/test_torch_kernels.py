"""The port's kernels (go_curdleproofs_tpu_torch/ops/kernels.py).

On the CPU each wrapper runs its plain version; here those are held against
the JAX package's Pallas kernels in interpret mode (as tests/
test_rns_kernels.py runs them) and the host oracle, on the same inputs, by
value (exact). The CUDA kernels themselves run only on a card: the `cuda`
test holds them against the plain versions there (python -m pytest -m cuda
tests/test_torch_kernels.py)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_curdleproofs_tpu.ops import curve as jcurve
from go_curdleproofs_tpu.ops import fp_rns, rns, rns_kernels
from go_curdleproofs_tpu.ops.field_backend import Fp as JFp
from go_curdleproofs_tpu.utils import field_host as fh
from go_curdleproofs_tpu.utils.field_host import P
from go_curdleproofs_tpu_torch import convert
from go_curdleproofs_tpu_torch.ops import curve, fp, fr, kernels

torch.set_num_threads(1)
CPU = torch.device("cpu")
W = curve.NUM_WINDOWS


def _rand_points(rng, n, n_inf=0):
    pts = [fh.g1_mul(fh.G1_GEN, int.from_bytes(rng.bytes(32), "little")
                     % (fh.R - 1) + 1) for _ in range(n)]
    for i in rng.choice(n, size=n_inf, replace=False):
        pts[int(i)] = None
    return pts


def test_pow_fixed_plain_matches_pallas_kernel():
    rng = np.random.default_rng(43)
    e = 0xB7E15162_8AED2A6B              # 64-bit, mixed bit pattern
    xs = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(5)]
    xs += [0, 1, P - 1]
    want = rns.to_ints(rns_kernels.pow_fixed(rns.from_ints(xs), e,
                                             interpret=True))
    got = fp.to_ints(kernels.pow_fixed(fp.from_ints(xs, CPU), e))
    assert got == want == [pow(x, e, P) for x in xs]


@pytest.mark.parametrize("exponent", [(P + 1) // 4, P - 2],
                         ids=["sqrt", "inverse"])
def test_pow_fixed_full_exponents_match_rns_ladder(exponent):
    rng = np.random.default_rng(7)
    xs = [0, 1, P - 1] + [int.from_bytes(rng.bytes(48), "little") % P
                          for _ in range(5)]
    want = fp_rns.to_ints(fp_rns.pow_fixed(fp_rns.from_ints(xs), exponent))
    got = fp.to_ints(kernels.pow_fixed(fp.from_ints(xs, CPU), exponent))
    assert got == want == [pow(x, exponent, P) for x in xs]


def test_windowed_combine_plain_matches_pallas_kernel():
    """acc = 16*acc + sel[w] over 33 windows, 8 rows, with infinity
    entries: port plain vs the Pallas kernel (interpret) vs the oracle."""
    rng = np.random.default_rng(44)
    rows = 8
    pts = _rand_points(rng, W * rows, n_inf=5)
    jp = jcurve.from_affine_host(pts)
    sel_j = tuple(np.asarray(c.limbs).reshape(W, rows, -1) for c in jp)
    kout = rns_kernels.windowed_combine(
        tuple(jnp.asarray(s) for s in sel_j), (1, 1, 1), W, interpret=True)
    want = jcurve.to_affine_host(kout)

    sel = curve.pmap(lambda t: t.reshape(W, rows, fp.NWORDS),
                     curve.from_affine_host(pts, device=CPU))
    got = curve.to_affine_host(kernels.windowed_combine(sel))
    oracle = [fh.g1_combine_windows([pts[w * rows + r] for w in range(W)], 4)
              for r in range(rows)]
    assert got == want == oracle


def test_msm_select_reduce_plain_matches_pallas_kernel():
    """The MSM wide phase over the JAX package's own multiples table
    (handed over through convert.pointvec_from_jax), with an infinity lane,
    a zero scalar and two jobs on different rows."""
    rng = np.random.default_rng(45)
    n, m, k = 16, 2, 2
    vecs = [_rand_points(rng, n) for _ in range(k)]
    vecs[0][3] = None
    sv = jcurve.StackedVec.from_affine(vecs)
    scal = [[int.from_bytes(rng.bytes(32), "little") % fh.R
             for _ in range(n)] for _ in range(m)]
    scal[1][0] = 0
    digits = np.stack([jcurve.scalars_to_digits(s) for s in scal])
    rows = np.array([0, 1], np.int32)

    tab = jcurve.pmap_coords(lambda t: jnp.take(t, rows, axis=1), sv.table())
    wx, wy, wz = rns_kernels.msm_select_reduce(
        (tab.x.limbs, tab.y.limbs, tab.z.limbs), jnp.asarray(digits), 6,
        interpret=True)
    want = jcurve.to_affine_host(
        jcurve.PointVec(JFp(wx, 6), JFp(wy, 6), JFp(wz, 6)))

    ptab = convert.pointvec_from_jax(*(np.asarray(c.limbs) for c in tab),
                                     device=CPU)
    got_w = kernels.msm_select_reduce(
        ptab, torch.from_numpy(digits.astype(np.int32)))
    got = curve.to_affine_host(got_w)
    assert got == want
    combined = [fh.g1_combine_windows(got[i * W:(i + 1) * W], 4)
                for i in range(m)]
    assert combined == [fh.g1_msm([p for p in vecs[r] if p is not None],
                                  [s for p, s in zip(vecs[r], scal[i])
                                   if p is not None])
                        for i, r in enumerate(rows)]


def test_mont_mul_plain_matches_pallas_kernel():
    """B1 on the field's edge values and a batch that is no block multiple;
    a single-element operand multiplies the whole batch."""
    rng = np.random.default_rng(41)
    n = 70
    xs = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]
    ys = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]
    xs[:6] = [0, 1, P - 1, P - 2, 2, (P + 1) // 2]
    ys[:6] = [0, P - 1, P - 1, 1, (P - 1) // 2, 2]
    want = rns.to_ints(rns_kernels.mont_mul(rns.from_ints(xs),
                                            rns.from_ints(ys),
                                            interpret=True))
    a, b = fp.from_ints(xs, CPU), fp.from_ints(ys, CPU)
    got = fp.to_ints(kernels.mont_mul(a, b))
    assert got == want == [x * y % P for x, y in zip(xs, ys)]
    assert torch.equal(kernels.mont_mul(a, b), kernels.mont_mul_plain(a, b))
    assert torch.equal(fp.mul(a, b), kernels.mont_mul_plain(a, b))
    one = fp.from_ints([ys[7]], CPU)[0]                     # [12]
    assert fp.to_ints(kernels.mont_mul(a, one)) == \
        fp.to_ints(kernels.mont_mul(one, a)) == [x * ys[7] % P for x in xs]
    plane = a.reshape(7, 10, fp.NWORDS)
    assert fp.to_ints(kernels.mont_mul(plane, one)) == \
        [x * ys[7] % P for x in xs]


def test_point_add_double_plain_match_pallas_kernels():
    """B2 and B3 against the fused Pallas kernels (interpret) and the
    oracle: infinity operands, P + P, P + (-P), and chained results."""
    rng = np.random.default_rng(42)
    m = 12
    pts, qts = _rand_points(rng, m), _rand_points(rng, m)
    pts[0] = None
    qts[1] = None
    pts[2] = qts[2] = None
    qts[3] = pts[3]
    qts[4] = (pts[4][0], (P - pts[4][1]) % P)
    jp, jq = jcurve.from_affine_host(pts), jcurve.from_affine_host(qts)
    pv = curve.from_affine_host(pts, device=CPU)
    qv = curve.from_affine_host(qts, device=CPU)

    got = curve.to_affine_host(kernels.point_add(pv, qv))
    assert got == jcurve.to_affine_host(
        rns_kernels.point_add(jp, jq, interpret=True))
    assert got == [fh.g1_add(p, q) for p, q in zip(pts, qts)]
    got = curve.to_affine_host(kernels.point_double(pv))
    assert got == jcurve.to_affine_host(
        rns_kernels.point_double(jp, interpret=True))
    assert got == [fh.g1_add(p, p) for p in pts]

    # the same tensors as both operands, and results fed back in
    assert curve.to_affine_host(kernels.point_add(pv, pv)) == got
    r2 = kernels.point_add(kernels.point_add(pv, qv),
                           kernels.point_double(qv))
    assert curve.to_affine_host(r2) == [
        fh.g1_add(fh.g1_add(p, q), fh.g1_add(q, q))
        for p, q in zip(pts, qts)]
    # curve.add / curve.double are these wrappers
    assert all(torch.equal(u, v) for u, v in
               zip(curve.add(pv, qv), kernels.point_add_plain(pv, qv)))
    assert all(torch.equal(u, v) for u, v in
               zip(curve.double(pv), kernels.point_double_plain(pv)))


def test_plain_versions_call_no_wrapper(monkeypatch):
    """On the card the kernels are held against their plain versions, so a
    plain version must never reach a wrapper (it would be a kernel held
    against kernels)."""
    def boom(*a, **k):
        raise AssertionError("a plain version called a kernel wrapper")

    rng = np.random.default_rng(47)
    pv = curve.from_affine_host(_rand_points(rng, 4), device=CPU)
    x = fp.from_ints([3, 5, 7, 11], CPU)
    table = curve.build_table(curve.pmap(lambda t: t[None], pv))   # [9,1,4]
    dig = torch.from_numpy(rng.integers(-8, 9, (1, 4, 3), dtype=np.int32))
    sel = curve.pmap(lambda t: t.reshape(2, 2, fp.NWORDS), pv)
    s = fr.from_ints([3, 5, 7, 11], CPU)
    state = torch.arange(200, dtype=torch.uint8)
    stream = torch.arange(180, dtype=torch.uint8)
    pbs = torch.tensor([9], dtype=torch.uint8)
    assert set(kernels.KERNEL_NAMES) == set(kernels.launches) \
        and len(kernels.KERNEL_NAMES) == 11
    for name in kernels.KERNEL_NAMES:
        monkeypatch.setattr(kernels, name, boom)
    kernels.mont_mul_plain(x, x)
    kernels.point_add_plain(pv, pv)
    kernels.point_double_plain(pv)
    kernels.pow_fixed_plain(x, 0b1011)
    kernels.windowed_combine_plain(sel)
    kernels.msm_select_reduce_plain(table, dig)
    kernels.point_x16_add_plain(pv, pv)
    kernels.fr_mont_mul_plain(s, s)
    kernels.fr_pow_fixed_plain(s, 0b1011)
    kernels.strobe_absorb_stream_plain(state, stream, 20, pbs, final_pb=3)
    kernels.strobe_challenge32_plain(state, b"label", 20, 7)


def test_wrappers_check_inputs_and_never_fall_back():
    x = fp.from_ints([1, 2, 3], CPU)
    with pytest.raises(TypeError):
        kernels.pow_fixed(x.to(torch.int64), 3)
    with pytest.raises(ValueError):
        kernels.pow_fixed(x, 0)
    with pytest.raises(ValueError):
        kernels.windowed_combine(curve.PointVec(x, x, x))      # not [W, rows]
    bad = curve.PointVec(*(torch.zeros(8, 1, 4, 12, dtype=torch.int32)
                           for _ in range(3)))
    with pytest.raises(ValueError):                            # 8 entries
        kernels.msm_select_reduce(bad, torch.zeros(1, 4, W, dtype=torch.int32))
    # B1-B3: a view is refused, not silently copied; shapes must agree
    pv = curve.PointVec(x, x, x)
    with pytest.raises(ValueError):
        kernels.mont_mul(torch.cat([x, x])[0::2], x)
    with pytest.raises(ValueError):
        kernels.mont_mul(x, x[:2])
    with pytest.raises(ValueError):
        kernels.point_add(pv, curve.pmap(lambda t: t[:2], pv))
    with pytest.raises(ValueError):
        kernels.point_double(curve.pmap(lambda t: torch.cat([t, t])[0::2],
                                        pv))
    with pytest.raises(TypeError):
        kernels.point_double(curve.pmap(lambda t: t.to(torch.int64), pv))
    # a device that is neither the CPU nor CUDA has no route, plain or not
    meta = torch.empty((4, fp.NWORDS), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kernels.pow_fixed(meta, 3)


def test_point_x16_add_plain_matches_pallas_kernel():
    """B4 against the fused Pallas kernel (interpret) and the oracle on the
    cases of tests/test_rns_kernels.py:94-122: infinity in either operand,
    sel equal to 16 * acc (the add is a doubling), the inverse pair."""
    rng = np.random.default_rng(49)
    m = 8
    pts, qts = _rand_points(rng, m), _rand_points(rng, m)
    pts[0] = None
    qts[1] = None
    pts[2] = qts[2] = None
    qts[3] = fh.g1_mul(pts[3], 16)
    qts[4] = fh.g1_neg(fh.g1_mul(pts[4], 16))
    qts[5] = pts[5]
    jp, jq = jcurve.from_affine_host(pts), jcurve.from_affine_host(qts)
    pv = curve.from_affine_host(pts, device=CPU)
    qv = curve.from_affine_host(qts, device=CPU)
    got = curve.to_affine_host(kernels.point_x16_add(pv, qv))
    assert got == jcurve.to_affine_host(
        rns_kernels.point_x16_add(jp, jq, interpret=True))
    assert got == [fh.g1_add(fh.g1_mul(p, 16) if p else None, q)
                   for p, q in zip(pts, qts)]
    assert got[4] is None
    # curve.x16_add is this wrapper; the result never aliases an input
    out = curve.x16_add(pv, qv)
    assert all(torch.equal(u, v) for u, v in
               zip(out, kernels.point_x16_add_plain(pv, qv)))
    assert all(o.data_ptr() != i.data_ptr() for o in out for i in (*pv, *qv))


def test_scalar_mul_steps_equals_scalar_mul_device_and_oracle():
    """The window loop on B4 and the one-launch form on B5 give the same
    points, with a zero scalar, r - 1 and an infinity among them."""
    rng = np.random.default_rng(50)
    pts = _rand_points(rng, 4)
    pts[2] = None
    sc = [0, fh.R - 1] + [int.from_bytes(rng.bytes(32), "little") % fh.R
                          for _ in range(2)]
    pv = curve.from_affine_host(pts, device=CPU)
    dig = torch.from_numpy(curve.scalars_to_digits(sc))
    steps = curve.to_affine_host(curve.scalar_mul_steps(pv, dig))
    assert steps == curve.to_affine_host(curve.scalar_mul_device(pv, dig))
    assert steps == [fh.g1_mul(p, s) for p, s in zip(pts, sc)]


def test_new_wrappers_check_inputs_and_never_fall_back():
    x = fp.from_ints([1, 2, 3], CPU)
    pv = curve.PointVec(x, x, x)
    s = fr.from_ints([1, 2, 3], CPU)
    with pytest.raises(ValueError):                         # shapes differ
        kernels.point_x16_add(pv, curve.pmap(lambda t: t[:2], pv))
    with pytest.raises(ValueError):                         # a view
        kernels.point_x16_add(pv, curve.pmap(
            lambda t: torch.cat([t, t])[0::2], pv))
    with pytest.raises(TypeError):
        kernels.point_x16_add(pv, curve.pmap(lambda t: t.to(torch.int64),
                                             pv))
    with pytest.raises(ValueError):                         # 12-word elements
        kernels.fr_mont_mul(x, x)
    with pytest.raises(ValueError):
        kernels.fr_mont_mul(s, s[:2])
    with pytest.raises(ValueError):
        kernels.fr_mont_mul(torch.cat([s, s])[0::2], s)
    with pytest.raises(TypeError):
        kernels.fr_mont_mul(s.to(torch.int64), s.to(torch.int64))
    with pytest.raises(ValueError):
        kernels.fr_pow_fixed(s, 0)
    with pytest.raises(ValueError):
        kernels.fr_pow_fixed(s, 1 << 256)
    with pytest.raises(ValueError):
        kernels.fr_pow_fixed(x, 3)
    with pytest.raises(TypeError):
        kernels.fr_pow_fixed(s.to(torch.int64), 3)

    state = torch.zeros(200, dtype=torch.uint8)
    stream = torch.zeros(40, dtype=torch.uint8)
    none = torch.zeros(0, dtype=torch.uint8)
    with pytest.raises(ValueError):                         # [199] state
        kernels.strobe_absorb_stream(state[:199], stream, 0, none)
    with pytest.raises(ValueError):                         # position 166
        kernels.strobe_absorb_stream(state, stream, 166, none)
    with pytest.raises(ValueError):                         # one crossing
        kernels.strobe_absorb_stream(state, stream, 150, none)
    with pytest.raises(TypeError):
        kernels.strobe_absorb_stream(state.to(torch.int32), stream, 0, none)
    with pytest.raises(ValueError):
        kernels.strobe_absorb_stream(state, torch.zeros(80, dtype=torch.uint8)
                                     [0::2], 0, none)
    with pytest.raises(ValueError):
        kernels.strobe_challenge32(state, b"l" * 33, 0, 0)
    with pytest.raises(ValueError):
        kernels.strobe_challenge32(state, b"label", 0, 167)
    with pytest.raises(TypeError):
        kernels.strobe_challenge32(state.to(torch.int32), b"label", 0, 0)
    meta = torch.empty((4, fr.NWORDS), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kernels.fr_pow_fixed(meta, 3)


def test_plain_route_counts_no_launch():
    kernels.reset_launches()
    kernels.pow_fixed(fp.from_ints([5], CPU), 3)
    assert kernels.launches == {name: 0 for name in kernels.KERNEL_NAMES}


def test_cuda_constants_match_field():
    """fp.cuh's p, -p^-1 mod 2^32 and R mod p (the card compiles them;
    here they are read back and checked)."""
    src = (Path(kernels.__file__).parent / "csrc" / "fp.cuh").read_text()

    def words(name):
        body = re.search(name + r"\[NW\] = \{([^}]*)\}", src).group(1)
        ws = [int(w.strip().rstrip("u"), 16) for w in body.split(",")]
        return sum(w << (32 * i) for i, w in enumerate(ws))

    assert words("kP") == P
    assert words("kOne") == (1 << 384) % P
    pinv = int(re.search(r"kPInv = (0x[0-9a-f]+)u", src).group(1), 16)
    assert (pinv * P) % (1 << 32) == (1 << 32) - 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device):
    rng = np.random.default_rng(46)
    xs = [0, 1, P - 1] + [int.from_bytes(rng.bytes(48), "little") % P
                          for _ in range(61)]
    x = fp.from_ints(xs, cuda_device)
    e = (P + 1) // 4
    assert torch.equal(kernels.pow_fixed(x, e), kernels.pow_fixed_plain(x, e))

    pts = _rand_points(rng, 64, n_inf=2)
    table = curve.StackedVec.from_affine([pts], device=cuda_device).table()
    dig = torch.from_numpy(rng.integers(-8, 9, (1, 128, W), dtype=np.int32))
    dig = dig.to(cuda_device)
    got = kernels.msm_select_reduce(table, dig)
    want = kernels.msm_select_reduce_plain(table, dig)
    assert curve.to_affine_host(got) == curve.to_affine_host(want)

    sel = curve.pmap(lambda t: t.transpose(0, 1).contiguous(), got)
    out = kernels.windowed_combine(sel)
    assert all(torch.equal(a, b) for a, b in
               zip(out, kernels.windowed_combine_plain(sel)))


@pytest.mark.cuda
def test_cuda_pointwise_kernels_match_plain(cuda_device):
    """B1-B3 on the card against their plain versions, exact, with the
    edge cases, a broadcast operand and aliased operands; the inverse
    ladder (B7 with exponent p - 2) with a zero."""
    rng = np.random.default_rng(48)
    xs = [0, 1, P - 1] + [int.from_bytes(rng.bytes(48), "little") % P
                          for _ in range(97)]
    a = fp.from_ints(xs, cuda_device)
    b = fp.from_ints(xs[::-1], cuda_device)
    kernels.reset_launches()
    assert torch.equal(kernels.mont_mul(a, b), kernels.mont_mul_plain(a, b))
    assert torch.equal(kernels.mont_mul(a, a), kernels.mont_mul_plain(a, a))
    assert torch.equal(kernels.mont_mul(a, b[5]),
                       kernels.mont_mul_plain(a, b[5]))
    assert kernels.launches["mont_mul"] == 3
    assert torch.equal(kernels.pow_fixed(a, P - 2),
                       kernels.pow_fixed_plain(a, P - 2))

    pts, qts = _rand_points(rng, 40, n_inf=2), _rand_points(rng, 40, n_inf=2)
    qts[3] = pts[3]
    qts[4] = fh.g1_neg(pts[4])
    pv = curve.from_affine_host(pts, device=cuda_device)
    qv = curve.from_affine_host(qts, device=cuda_device)
    for got, want in ((kernels.point_add(pv, qv),
                       kernels.point_add_plain(pv, qv)),
                      (kernels.point_add(pv, pv),
                       kernels.point_add_plain(pv, pv)),
                      (kernels.point_double(pv),
                       kernels.point_double_plain(pv))):
        assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert kernels.launches["point_add"] == 2
    assert kernels.launches["point_double"] == 1
    with pytest.raises(ValueError):
        kernels.mont_mul(torch.cat([a, a])[0::2], a)


@pytest.mark.cuda
def test_cuda_device_prover_kernels_match_plain(cuda_device):
    """B4, B8, the Fr multiply and the two transcript kernels on the card
    against their plain versions, exact, with the edge cases and the
    launch counts."""
    rng = np.random.default_rng(51)
    dev = cuda_device
    xs = [0, 1, fh.R - 1] + [int.from_bytes(rng.bytes(32), "little") % fh.R
                             for _ in range(125)]
    a, b = fr.from_ints(xs, dev), fr.from_ints(xs[::-1], dev)
    kernels.reset_launches()
    assert torch.equal(kernels.fr_mont_mul(a, b),
                       kernels.fr_mont_mul_plain(a, b))
    assert torch.equal(kernels.fr_mont_mul(a, b[5]),
                       kernels.fr_mont_mul_plain(a, b[5]))
    assert kernels.launches["fr_mont_mul"] == 2
    a8 = a[:8].contiguous()
    assert torch.equal(kernels.fr_pow_fixed(a8, fh.R - 2),
                       kernels.fr_pow_fixed_plain(a8, fh.R - 2))
    assert kernels.launches["fr_pow_fixed"] == 1

    pts, qts = _rand_points(rng, 24, n_inf=2), _rand_points(rng, 24, n_inf=2)
    qts[3] = fh.g1_mul(pts[3], 16) if pts[3] else None
    qts[4] = fh.g1_neg(fh.g1_mul(pts[4], 16)) if pts[4] else None
    pv = curve.from_affine_host(pts, device=dev)
    qv = curve.from_affine_host(qts, device=dev)
    got = kernels.point_x16_add(pv, qv)
    assert all(torch.equal(u, v) for u, v in
               zip(got, kernels.point_x16_add_plain(pv, qv)))
    assert kernels.launches["point_x16_add"] == 1

    state = torch.from_numpy(rng.integers(0, 256, 200, dtype=np.uint8)).to(dev)
    for n, pos in ((1000, 17), (6, 160), (166 * 3, 0), (40, 3)):
        stream = torch.from_numpy(
            rng.integers(0, 256, n, dtype=np.uint8)).to(dev)
        pbs = torch.from_numpy(rng.integers(
            0, 166, (pos + n) // 166, dtype=np.uint8)).to(dev)
        for final_pb in (None, 7):
            assert torch.equal(
                kernels.strobe_absorb_stream(state, stream, pos, pbs,
                                             final_pb),
                kernels.strobe_absorb_stream_plain(state, stream, pos, pbs,
                                                   final_pb))
    for pos, pb in ((0, 0), (41, 12), (150, 3), (165, 160)):
        g_st, g_ch = kernels.strobe_challenge32(state, b"ipa_gamma", pos, pb)
        w_st, w_ch = kernels.strobe_challenge32_plain(state, b"ipa_gamma",
                                                      pos, pb)
        assert torch.equal(g_st, w_st) and torch.equal(g_ch, w_ch)
    assert kernels.launches["strobe_challenge32"] == 4
    with pytest.raises(ValueError):
        kernels.fr_mont_mul(torch.cat([a, a])[0::2], a)
