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
from go_curdleproofs_tpu_torch.ops import curve, fp, fr, glv, kernels

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
    xb, wl, _, _ = _decode_case(rng, 3)
    assert set(kernels.KERNEL_NAMES) == set(kernels.launches) \
        and len(kernels.KERNEL_NAMES) == 13
    for name in kernels.KERNEL_NAMES:
        monkeypatch.setattr(kernels, name, boom)
    kernels.mont_mul_plain(x, x)
    kernels.point_add_plain(pv, pv)
    kernels.point_double_plain(pv)
    kernels.pow_fixed_plain(x, 0b1011)
    kernels.windowed_combine_plain(sel)
    kernels.msm_select_reduce_plain(table, dig)
    kernels.point_x16_add_plain(pv, pv)
    monkeypatch.setattr(kernels, "point_x16_add_select", boom)
    kernels.point_x16_add_select_plain(
        pv, curve.pmap(lambda t: t[:, 0], table), dig[0], 1)
    kernels.fr_mont_mul_plain(s, s)
    kernels.fr_pow_fixed_plain(s, 0b1011)
    kernels.strobe_absorb_stream_plain(state, stream, 20, pbs, final_pb=3)
    kernels.strobe_challenge32_plain(state, b"label", 20, 7)
    kernels.decode_points_plain(xb, wl)
    kernels.glv_recode_plain(s)


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
    dig = torch.from_numpy(glv.scalars_to_digits_glv(sc))
    steps = curve.to_affine_host(curve.scalar_mul_steps(pv, dig))
    assert steps == curve.to_affine_host(curve.scalar_mul_device(pv, dig))
    assert steps == [fh.g1_mul(p, s) for p, s in zip(pts, sc)]


def _select_case(rng, device=CPU):
    """18 points as a [2, 9] batch, their extended table [9, 2, 18],
    digits [2, 18, 3] (window 0 runs through -8..8, window 2 is all zero)
    and an accumulator with infinity rows, a row that meets its operand
    after the four doublings (the add is a doubling) and a row that meets
    its negative (the sum cancels). Returns the torch inputs and the host
    points behind them."""
    pts = _rand_points(rng, 18)
    pts[5] = pts[13] = None
    digits = rng.integers(-8, 9, (2, 18, 3), dtype=np.int32)
    digits[..., 0].reshape(-1)[:17] = np.arange(-8, 9)
    digits[..., 0].reshape(-1)[17:] = [-8, 8, 0] + [3] * 16
    digits[..., 2] = 0
    acc = _rand_points(rng, 36)
    for i in (0, 9, 20):
        acc[i] = None
    inv16 = pow(16, -1, fh.R)
    # extended lane 2i is point i: lanes 4 and 6 are points 2 and 3
    d4, d6 = int(digits[0, 4, 0]), int(digits[0, 6, 0])
    acc[4] = fh.g1_mul(pts[2], d4 * inv16 % fh.R)
    acc[6] = fh.g1_mul(pts[3], -d6 * inv16 % fh.R)
    pv = curve.pmap(lambda t: t.reshape(2, 9, fp.NWORDS),
                    curve.from_affine_host(pts, device=device))
    table = curve.extend_table_glv(curve.build_table(pv))
    accv = curve.pmap(lambda t: t.reshape(2, 18, fp.NWORDS),
                      curve.from_affine_host(acc, device=device))
    return pts, acc, accv, table, torch.from_numpy(digits).to(device)


@pytest.mark.parametrize("w", [0, 1, 2])
def test_point_x16_add_select_matches_plain_select_and_pallas_kernel(w):
    """B4's second load stage: the plain version equals point_x16_add_plain
    on curve.table_select word for word, the JAX package's step (its
    select, then the fused Pallas kernel in interpret mode) and the oracle
    by affine value."""
    rng = np.random.default_rng(52)
    pts, acc, accv, table, digits = _select_case(rng)
    got = kernels.point_x16_add_select(accv, table, digits, w)
    d = digits[..., w]
    sel = curve.table_select(table, fp.neg(table.y), d.abs().long(), d < 0)
    want = kernels.point_x16_add_plain(accv, sel)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert all(torch.equal(u, v) for u, v in zip(
        got, kernels.point_x16_add_select_plain(accv, table, digits, w)))
    assert got.x.shape == (2, 18, fp.NWORDS)

    jtab = jcurve.extend_table_glv(
        jcurve._build_table(jcurve.from_affine_host(pts)))
    jsel = jcurve._table_select(jtab,
                                jnp.asarray(digits[..., w].reshape(-1).numpy()))
    jout = rns_kernels.point_x16_add(jcurve.from_affine_host(acc),
                                     jcurve._settle_tags(jsel),
                                     interpret=True)
    got_aff = curve.to_affine_host(got)
    assert got_aff == jcurve.to_affine_host(jout)
    lam_pts = curve.to_affine_host(curve.pmap(lambda t: t[1], table))
    flat = digits[..., w].reshape(-1).tolist()
    assert got_aff == [fh.g1_add(fh.g1_mul(a, 16) if a else None,
                                 fh.g1_mul(q, dd % fh.R) if q else None)
                       for a, q, dd in zip(acc, lam_pts, flat)]
    if w == 0:
        assert got_aff[6] is None and got_aff[4] is not None


def test_point_x16_add_select_writes_into_out_and_in_place():
    rng = np.random.default_rng(53)
    _, _, accv, table, digits = _select_case(rng)
    want = kernels.point_x16_add_select(accv, table, digits, 1)
    out = curve.pmap(torch.zeros_like, accv)
    res = kernels.point_x16_add_select(accv, table, digits, 1, out=out)
    assert all(r is o for r, o in zip(res, out))
    assert all(torch.equal(u, v) for u, v in zip(out, want))
    acc2 = curve.pmap(torch.clone, accv)
    kernels.point_x16_add_select(acc2, table, digits, 1, out=acc2)
    assert all(torch.equal(u, v) for u, v in zip(acc2, want))
    kernels.reset_launches()
    kernels.point_x16_add_select(accv, table, digits, 0)
    assert kernels.launches["point_x16_add"] == 0          # the CPU route


@pytest.mark.parametrize("scalars", ["zero", "one", "r-1", "random"])
def test_scalar_mul_steps_matches_both_packages_and_oracle(scalars):
    """The window loop (one point_x16_add_select a window) against the
    one-launch form, the oracle and the JAX package's scalar_mul_device,
    with an infinity among the points."""
    rng = np.random.default_rng(54)
    pts = _rand_points(rng, 4)
    pts[2] = None
    sc = {"zero": [0] * 4, "one": [1] * 4, "r-1": [fh.R - 1] * 4,
          "random": [int.from_bytes(rng.bytes(32), "little") % fh.R
                     for _ in range(4)]}[scalars]
    pv = curve.from_affine_host(pts, device=CPU)
    dig = glv.scalars_to_digits_glv(sc)
    steps = curve.to_affine_host(
        curve.scalar_mul_steps(pv, torch.from_numpy(dig)))
    assert steps == curve.to_affine_host(
        curve.scalar_mul_device(pv, torch.from_numpy(dig)))
    assert steps == [fh.g1_mul(p, s) for p, s in zip(pts, sc)]
    assert steps == jcurve.to_affine_host(jcurve.scalar_mul_device(
        jcurve.from_affine_host(pts), jnp.asarray(dig)))


def test_scalar_mul_steps_is_one_wrapper_call_a_window(monkeypatch):
    """No select, no gather around the step: the loop calls the select
    entry once a window, in place, and selects nothing itself (on the CPU
    the entry's plain version does the one table_select of its window)."""
    rng = np.random.default_rng(55)
    pv = curve.from_affine_host(_rand_points(rng, 2), device=CPU)
    dig = torch.from_numpy(glv.scalars_to_digits_glv([5, fh.R - 7]))
    calls = []
    real = kernels.point_x16_add_select

    def counted(acc, table, digits, w, out=None):
        calls.append((w, out is acc))
        return real(acc, table, digits, w, out=out)

    def boom(*a, **k):
        raise AssertionError("scalar_mul_steps selected outside the kernel")

    selects = []
    real_select = curve.table_select
    monkeypatch.setattr(kernels, "point_x16_add_select", counted)
    monkeypatch.setattr(curve, "table_select", lambda *a: (
        selects.append(len(calls)), real_select(*a))[1])
    monkeypatch.setattr(curve, "table_select_windows", boom)
    monkeypatch.setattr(curve, "x16_add", boom)
    got = curve.to_affine_host(curve.scalar_mul_steps(pv, dig[:, :5]))
    assert calls == [(w, True) for w in range(5)]
    assert selects == [1, 2, 3, 4, 5]       # inside the entry, one a window
    assert len(got) == 2


def test_select_entry_checks_inputs_and_never_falls_back():
    rng = np.random.default_rng(56)
    _, _, acc, table, digits = _select_case(rng)
    ok = lambda **kw: kernels.point_x16_add_select(
        kw.get("acc", acc), kw.get("table", table),
        kw.get("digits", digits), kw.get("w", 0), out=kw.get("out"))
    ok()
    with pytest.raises(TypeError):                          # int64 digits
        ok(digits=digits.long())
    with pytest.raises(TypeError):
        ok(acc=curve.pmap(lambda t: t.long(), acc))
    with pytest.raises(ValueError):                         # a view
        ok(digits=torch.cat([digits, digits], -1)[..., 0::2])
    with pytest.raises(ValueError):
        ok(table=curve.pmap(lambda t: torch.cat([t, t])[0::2], table))
    with pytest.raises(ValueError):                         # 8 entries
        ok(table=curve.pmap(lambda t: t[:8].contiguous(), table))
    for w in (-1, 3):
        with pytest.raises(ValueError):
            ok(w=w)
    with pytest.raises(ValueError):                         # 17 lanes of digits
        ok(digits=digits[:, :17].contiguous())
    with pytest.raises(ValueError):                         # 17 lanes of points
        ok(acc=curve.pmap(lambda t: t[:, :17].contiguous(), acc))
    with pytest.raises(ValueError):                         # out of another shape
        ok(out=curve.pmap(lambda t: t[:1].contiguous(), acc))
    with pytest.raises(ValueError):                         # no route
        ok(acc=curve.pmap(lambda t: t.to("meta"), acc),
           table=curve.pmap(lambda t: t.to("meta"), table),
           digits=digits.to("meta"))
    with pytest.raises(ValueError):
        kernels.pow_fixed(acc.x, 3, _threads=48)


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
    with pytest.raises(ValueError):                         # position 166
        kernels.strobe_challenge32(state, b"l" * 33, 166, 0)
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
    """fp.cuh's p and R mod p, and the immediates of fp_asm.cuh: p's words
    and -p^-1 mod 2^32 (the card compiles them; here they are read back
    and checked)."""
    csrc = Path(kernels.__file__).parent / "csrc"
    src = (csrc / "fp.cuh").read_text()

    def words(name):
        body = re.search(name + r"\[NW\] = \{([^}]*)\}", src).group(1)
        ws = [int(w.strip().rstrip("u"), 16) for w in body.split(",")]
        return sum(w << (32 * i) for i, w in enumerate(ws))

    assert words("kP") == P
    assert words("kOne") == (1 << 384) % P
    asm = (csrc / "fp_asm.cuh").read_text()
    pinvs = set(re.findall(r"mul\.lo\.u32 mi, \w+, (0x[0-9a-f]+);", asm))
    assert len(pinvs) == 1
    pinv = int(pinvs.pop(), 16)
    assert (pinv * P) % (1 << 32) == (1 << 32) - 1
    p_words = {(P >> (32 * j)) & 0xFFFFFFFF for j in range(12)}
    assert {int(h, 16) for h in re.findall(r"0x[0-9a-f]{8}", asm)} \
        == p_words | {pinv}


def _decode_case(rng, n):
    """n points for decode_points: subgroup points of both signs, and at
    every eighth (from the fourth on) an x off the curve, a point on the
    curve outside the subgroup (one such point plus a subgroup point) or
    (0, +-2) (order 3). Returns (x bytes [n, 48] uint8, signs [n] uint8,
    the flags each point must get or None off the curve, the y of each
    point on the curve)."""
    while True:
        x = int.from_bytes(rng.bytes(48), "little") % P
        y = fh.fp_sqrt((x * x % P * x + 4) % P)
        if y is not None and not fh.g1_in_subgroup((x, y)):
            bad = (x, y)
            break
    step = fh.g1_mul(fh.G1_GEN, int.from_bytes(rng.bytes(31), "little"))
    pt = fh.g1_mul(fh.G1_GEN, int.from_bytes(rng.bytes(31), "little"))
    rows, signs, flags, ys = [], [], [], []
    for i in range(n):
        kind = (i // 8) % 3 if i % 8 == 3 else None
        cur, f = pt, 3
        pt = fh.g1_add(pt, step)
        if kind == 0:
            while True:
                x = int.from_bytes(rng.bytes(48), "little") % P
                if fh.fp_sqrt((x * x % P * x + 4) % P) is None:
                    break
            rows.append(x.to_bytes(48, "big"))
            signs.append(i >> 4 & 1)
            flags.append(None)
            ys.append(None)
            continue
        if kind == 1:
            cur, f = fh.g1_add(bad, cur), 1
        elif kind == 2:
            cur, f = (0, 2 if i & 16 else P - 2), 1
        rows.append(cur[0].to_bytes(48, "big"))
        signs.append(int(fh.fp_lexicographically_largest(cur[1])))
        flags.append(f)
        ys.append(cur[1])
    xb = torch.tensor(np.frombuffer(b"".join(rows), np.uint8).reshape(n, 48))
    return xb, torch.tensor(signs, dtype=torch.uint8), flags, ys


def test_decode_points_plain_matches_jax_decode_program():
    """decode_points' plain version against the JAX package's decode
    program on 8 lanes of every kind: the y of each point on the curve,
    and the JAX verdict (on the curve and in the subgroup) as both flags
    set; the flags themselves against the host."""
    from go_curdleproofs_tpu.ops import codec_batch as jcodec_batch
    from go_curdleproofs_tpu.ops import field_backend as jfield
    from go_curdleproofs_tpu.ops import glv as jglv
    rng = np.random.default_rng(61)
    xb, wl, flags, ys = _decode_case(rng, 28)
    idx = [0, 3, 11, 19, 20, 27, 4, 1]        # every kind, both signs
    xb, wl = xb[idx].contiguous(), wl[idx].contiguous()
    flags, ys = [flags[i] for i in idx], [ys[i] for i in idx]
    out, pts = kernels.decode_points(xb, wl)
    out = out.numpy()
    xs = [int.from_bytes(bytes(r.tolist()), "big") for r in xb]
    y_dig, ok = jcodec_batch._decode_program(
        jfield.from_ints(xs), jnp.asarray(wl.numpy().astype(bool)),
        jnp.asarray(jglv.digits_nophi(jglv.LAMBDA, 8)))
    y_dig, ok = np.asarray(y_dig), np.asarray(ok)
    for row, f, y, yd, k in zip(out, flags, ys, y_dig, ok):
        assert f is None and row[12] & 1 == 0 or row[12] == f
        assert (row[12] == 3) == bool(k)
        if f is not None:
            got = int.from_bytes(row[:12].tobytes(), "little")
            assert got == y == sum(int(v) << (8 * j)
                                   for j, v in enumerate(yd))
    # the points' planes: (x : y : 1) in Montgomery form, where on the curve
    on = [i for i, f in enumerate(flags) if f is not None]
    assert tuple(pts.shape) == (3, 8, 12) and pts.dtype == torch.int32
    assert curve.to_affine_host(curve.PointVec(*pts[:, on])) == [
        (xs[i], ys[i]) for i in on]
    assert fp.to_ints(pts[2]) == [1] * 8


def test_decode_points_checks_inputs_and_never_falls_back():
    xb = torch.zeros(4, 48, dtype=torch.uint8)
    wl = torch.zeros(4, dtype=torch.uint8)
    with pytest.raises(ValueError):                         # [4, 47]
        kernels.decode_points(xb[:, :47].contiguous(), wl)
    with pytest.raises(ValueError):                         # 3 signs
        kernels.decode_points(xb, wl[:3])
    with pytest.raises(TypeError):
        kernels.decode_points(xb.to(torch.int32), wl)
    with pytest.raises(TypeError):
        kernels.decode_points(xb, wl.bool())
    with pytest.raises(ValueError):                         # a view
        kernels.decode_points(torch.zeros(8, 48, dtype=torch.uint8)[0::2],
                              wl)
    meta = torch.empty((4, 48), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        kernels.decode_points(meta, wl.to("meta"))
    kernels.reset_launches()
    kernels.decode_points(xb[:1], wl[:1])                   # x = 0
    assert kernels.launches["decode_points"] == 0


def test_decode_constants_match_field():
    """decode_points_kernel's constants (kernels.cu): R^2 mod p, 4 and beta
    in Montgomery form, (p - 1) / 2, the square-root exponent and its top
    nibble, z, and its points a block as the wrapper counts them."""
    src = (Path(kernels.__file__).parent / "csrc" / "kernels.cu").read_text()
    R = 1 << 384

    def words(name):
        body = re.search(name + r" = \{+([^}]*)\}", src).group(1)
        ws = [int(w.strip().rstrip("u"), 16) for w in body.split(",")]
        assert len(ws) == 12
        return sum(w << (32 * i) for i, w in enumerate(ws))

    assert words(r"kR2\[curdle::NW\]") == R * R % P
    assert words(r"kFour\[curdle::NW\]") == 4 * R % P
    assert words(r"kBeta\[curdle::NW\]") == glv.BETA * R % P
    assert words(r"kHalfP\[curdle::NW\]") == (P - 1) // 2
    e = words(r"Exponent kSqrtExponent")
    assert e == (P + 1) // 4
    top = int(re.search(r"kSqrtTop = (\d+);", src).group(1))
    assert top == (e.bit_length() - 1) // 4
    z = int(re.search(r"kZ = (0x[0-9a-f]+)ull;", src).group(1), 16)
    assert z == kernels._Z and z * z - 1 == glv.LAMBDA
    threads = int(re.search(r"kDecodeThreads = (\d+);", src).group(1))
    assert threads // 8 == kernels.DECODE_BLOCK_POINTS


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


# batches of the team product on the card: below a team, ragged warps and
# blocks, the verifier's [9, 1, 2048] plane, and above the grid-stride limit
# of 2 and 4 lanes a team (132 * 16 blocks of 128 threads)
MUL_SHAPES = [(1,), (3,), (31,), (33,), (1025,), (9, 1, 2048),
              (132 * 16 * 64 + 37,)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MUL_SHAPES, ids=str)
def test_cuda_mont_mul_team_at_batch_sizes(cuda_device, shape):
    """B1 on its lane teams at every kind of batch, with a broadcast
    operand on either side and the two operands one tensor, against the
    plain version word for word."""
    rng = np.random.default_rng(60)
    n = int(np.prod(shape))
    xs = [0, 1, P - 1] + [int.from_bytes(rng.bytes(48), "little") % P
                          for _ in range(min(n, 4096))]
    a = fp.from_ints([xs[i % len(xs)] for i in range(n)],
                     cuda_device).reshape(*shape, 12)
    b = a.flatten(0, -2).roll(7, 0).reshape(a.shape).contiguous()
    one = fp.from_ints([xs[-1]], cuda_device)[0]
    kernels.reset_launches()
    for u, v in ((a, b), (a, a), (a, one), (one, a)):
        assert torch.equal(kernels.mont_mul(u, v),
                           kernels.mont_mul_plain(u, v))
    assert kernels.launches["mont_mul"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("start", range(166))
def test_cuda_challenge_from_every_start(cuda_device, start):
    """strobe_challenge32 on the card from this start, labels of 0, 1, 9
    and 32 bytes, 1-3 attempts, against the plain version, the host
    Transcript and the lane model."""
    import random

    from test_torch_challenge_lanes import (LABELS, _host,
                                            challenge_lane_model,
                                            pos_begin_kinds,
                                            state_with_attempts)
    rng = random.Random(1000 + start)
    kinds = pos_begin_kinds(start, rng)
    for li, label in enumerate(LABELS):
        for attempts in (1, 2, 3):
            pb = kinds[(li + attempts + start) % len(kinds)]
            state = state_with_attempts(rng, start, pb, label, attempts)
            st = torch.tensor(list(state), dtype=torch.uint8,
                              device=cuda_device)
            g_st, g_ch = kernels.strobe_challenge32(st, label, start, pb)
            w_st, w_ch = kernels.strobe_challenge32_plain(st, label, start,
                                                          pb)
            assert torch.equal(g_st, w_st) and torch.equal(g_ch, w_ch)
            m_st, m_ch, _, _ = challenge_lane_model(state, label, start, pb)
            assert bytes(g_st.tolist()) == m_st
            host = _host(state, start, pb)
            assert int.from_bytes(bytes(g_ch.tolist()), "big") \
                == host.get_and_append_challenge(label) \
                == int.from_bytes(m_ch, "big")


POINT_SHAPES = [(1,), (2,), (3,), (4,), (7,), (24,), (33,), (1025,),
                (4, 1, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", POINT_SHAPES, ids=str)
def test_cuda_point_add_double_at_path_shapes(cuda_device, shape):
    """B2 and B3 (one 8-lane group a point) against their plain versions,
    exact, at the paths' batch sizes and ragged ones, with the corners in
    the first lanes (infinity in either or both operands, P + P, P + (-P))
    and P + P through one tensor; the sums against the oracle."""
    rng = np.random.default_rng(49)
    n = int(np.prod(shape))
    pts, qts = _rand_points(rng, 64), _rand_points(rng, 64)
    pts[0] = None
    qts[1] = None
    pts[2] = qts[2] = None
    qts[3] = pts[3]
    qts[4] = fh.g1_neg(pts[4])
    pts, qts = (pts * (n // 64 + 1))[:n], (qts * (n // 64 + 1))[:n]

    def batch(ps):
        return curve.pmap(lambda t: t.reshape(*shape, fp.NWORDS).contiguous(),
                          curve.from_affine_host(ps, device=cuda_device))

    pv, qv = batch(pts), batch(qts)
    kernels.reset_launches()
    added = kernels.point_add(pv, qv)
    for got, want in ((added, kernels.point_add_plain(pv, qv)),
                      (kernels.point_add(pv, pv),
                       kernels.point_add_plain(pv, pv)),
                      (kernels.point_double(pv),
                       kernels.point_double_plain(pv))):
        assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert kernels.launches["point_add"] == 2
    assert kernels.launches["point_double"] == 1
    assert curve.to_affine_host(added) == [fh.g1_add(p, q)
                                           for p, q in zip(pts, qts)]


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


@pytest.mark.cuda
def test_cuda_product_stress_and_square(cuda_device):
    """The carry-chained product on every pair of edge elements and on
    random pairs against the plain version and Python ints, and the
    dedicated square against the product."""
    rng = np.random.default_rng(57)
    edge = [0, 1, 2, P - 1, P - 2, (P + 1) // 2, (1 << 384) % P,
            (1 << 768) % P, (1 << 380) - 1]
    edge += [1 << k for k in (31, 32, 33, 63, 64, 191, 192, 351, 352, 380)]
    edge += [(1 << k) - 1 for k in (32, 64, 192, 352)]
    xs = [a for a in edge for _ in edge]
    ys = [b for _ in edge for b in edge]
    xs += [int.from_bytes(rng.bytes(48), "little") % P for _ in range(4096)]
    ys += [int.from_bytes(rng.bytes(48), "little") % P for _ in range(4096)]
    a, b = fp.from_ints(xs, cuda_device), fp.from_ints(ys, cuda_device)
    got = kernels.mont_mul(a, b)
    assert torch.equal(got, kernels.mont_mul_plain(a, b))
    assert fp.to_ints(got) == [x * y % P for x, y in zip(xs, ys)]
    assert torch.equal(kernels.pow_fixed(a, 2), kernels.mont_mul(a, a))


@pytest.mark.cuda
@pytest.mark.parametrize("exponent", [1, 2, 3, 15, 16, 17, (1 << 384) - 1,
                                      0x9000A00000B0000C0D, 0x1F3, 0x2F03,
                                      0x7000F, (P + 1) // 4, P - 2])
def test_cuda_pow_fixed_window_ladder(cuda_device, exponent):
    rng = np.random.default_rng(58)
    xs = [0, 1, P - 1] + [int.from_bytes(rng.bytes(48), "little") % P
                          for _ in range(30)]
    x = fp.from_ints(xs, cuda_device)
    for threads in (None, 64, 128):
        got = kernels.pow_fixed(x, exponent, _threads=threads)
        assert fp.to_ints(got) == [pow(v, exponent, P) for v in xs]
    assert torch.equal(got, kernels.pow_fixed_plain(x, exponent))


@pytest.mark.cuda
def test_cuda_point_x16_add_select_and_steps(cuda_device):
    """Both load stages of B4 on the card against their plain versions,
    in place too, and the window loop against the one-launch form."""
    rng = np.random.default_rng(59)
    pts, _, acc, table, digits = _select_case(rng, cuda_device)
    kernels.reset_launches()
    for w in range(3):
        got = kernels.point_x16_add_select(acc, table, digits, w)
        want = kernels.point_x16_add_select_plain(acc, table, digits, w)
        assert all(torch.equal(u, v) for u, v in zip(got, want))
        d = digits[..., w]
        sel = curve.table_select(table, fp.neg(table.y), d.abs().long(),
                                 d < 0)
        same = kernels.point_x16_add(acc, sel)
        assert all(torch.equal(u, v) for u, v in zip(same, want))
    acc2 = curve.pmap(torch.clone, acc)
    kernels.point_x16_add_select(acc2, table, digits, 0, out=acc2)
    assert all(torch.equal(u, v) for u, v in zip(
        acc2, kernels.point_x16_add_select_plain(acc, table, digits, 0)))
    assert kernels.launches["point_x16_add"] == 7
    sc = [0, 1, fh.R - 1, 12345]
    pv = curve.from_affine_host([p for p in pts if p][:4],
                                device=cuda_device)
    dig = torch.from_numpy(glv.scalars_to_digits_glv(sc)).to(cuda_device)
    kernels.reset_launches()
    steps = curve.scalar_mul_steps(pv, dig)
    assert kernels.launches["point_x16_add"] == W
    assert curve.to_affine_host(steps) == curve.to_affine_host(
        curve.scalar_mul_device(pv, dig))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 17, 585, 2141, 18720])
def test_cuda_decode_points_matches_plain(cuda_device, n):
    """decode_points on the card against its plain version on the card,
    word for word and flag for flag, at one point, a ragged 17, the two
    verify cells' decodes and a 32-proof batch's; the flags and y against
    the host."""
    rng = np.random.default_rng(n)
    xb, wl, flags, ys = _decode_case(rng, n)
    xb, wl = xb.to(cuda_device), wl.to(cuda_device)
    got, pts = kernels.decode_points(xb, wl)
    want, want_pts = kernels.decode_points_plain(xb, wl)
    assert torch.equal(got, want) and torch.equal(pts, want_pts)
    host = got.cpu().numpy()
    for row, f, y in zip(host, flags, ys):
        assert f is None and row[12] & 1 == 0 or row[12] == f
        assert y is None or int.from_bytes(row[:12].tobytes(), "little") == y
    on = [i for i, y in enumerate(ys) if y is not None][:64]
    xs = [int.from_bytes(bytes(r.tolist()), "big") for r in xb[on].cpu()]
    assert curve.to_affine_host(curve.PointVec(*pts[:, on])) == [
        (x, ys[i]) for x, i in zip(xs, on)]


@pytest.mark.cuda
def test_cuda_batch_decompress_is_one_launch(cuda_device):
    """One batch_decompress on the card: one decode_points launch and no
    other kernel launch."""
    from torch.profiler import ProfilerActivity, profile

    from go_curdleproofs_tpu.utils import codec as hcodec
    from go_curdleproofs_tpu_torch.ops import codec_batch
    pts = _rand_points(np.random.default_rng(71), 40)
    blobs = [hcodec.g1_to_bytes(p) for p in pts]
    assert codec_batch.batch_decompress(blobs, device=cuda_device) == pts
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert codec_batch.batch_decompress(blobs, device=cuda_device) == pts
        torch.cuda.synchronize()
    assert {k: v for k, v in kernels.launches.items() if v} == {
        "decode_points": 1}
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             for _ in range(e.count)]
    launched = [k for k in names if not k.startswith(("Memcpy", "Memset"))]
    assert len(launched) == 1 and "decode_points_kernel" in launched[0]
