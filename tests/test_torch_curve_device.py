"""The device MSM entry points of the port (ops/curve.py:
`msm_windows_device`, `msm_device`, `msm_stacked_device`,
`msm_rows_windows_device`, `msm_rows_device`, `to_affine_host_single`)
against the JAX package's and the host oracle, by affine value (exact),
with one JAX compile a function; more shapes against the oracle alone.
Physical folding is in test_torch_curve_fold.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_curdleproofs_tpu.ops import curve as jcurve
from go_curdleproofs_tpu.utils import field_host as fh
from go_curdleproofs_tpu_torch.ops import curve, glv

torch.set_num_threads(1)
CPU = torch.device("cpu")
W = curve.NUM_WINDOWS


def _scalar(rng):
    return int.from_bytes(rng.bytes(32), "little") % fh.R


def _pts(rng, n, holes=()):
    return [None if i in holes else fh.g1_mul(fh.G1_GEN, _scalar(rng) or 1)
            for i in range(n)]


def _port(flat, shape):
    """Host points -> a port PointVec of shape `shape` (+ [12] words)."""
    return curve.pmap(lambda t: t.reshape(shape + (curve.fp.NWORDS,)),
                      curve.from_affine_host(flat, device=CPU))


def _jax(flat, shape):
    return jcurve.pmap_coords(lambda t: t.reshape(shape + (t.shape[-1],)),
                              jcurve.from_affine_host(flat))


def _digits(rows):
    """[..., n] scalar rows -> (port digits tensor, numpy digits) [..., 2n,
    W]; both packages recode alike."""
    arr = np.stack([glv.scalars_to_digits_glv(r) for r in rows])
    assert np.array_equal(arr, np.stack([jcurve.scalars_to_digits(r)
                                         for r in rows]))
    return torch.from_numpy(arr), arr


@pytest.mark.parametrize("n,batch", [(8, (2,)), (16, (2, 2))])
def test_msm_device_and_windows_match_oracle(n, batch):
    rng = np.random.default_rng(n)
    jobs = int(np.prod(batch))
    pts = [_pts(rng, n, holes=(j,)) for j in range(jobs)]
    scs = [[_scalar(rng) for _ in range(n)] for _ in range(jobs)]
    scs[0][1] = 0
    pv = _port(sum(pts, []), batch + (n,))
    dig, _ = _digits(scs)
    dig = dig.reshape(batch + (2 * n, W))
    want = [fh.g1_msm(p, s) for p, s in zip(pts, scs)]
    out = curve.msm_device(pv, dig)
    assert tuple(out.x.shape) == batch + (curve.fp.NWORDS,)
    assert curve.to_affine_host(out) == want
    wins = curve.msm_windows_device(pv, dig)
    assert tuple(wins.x.shape) == batch + (W, curve.fp.NWORDS)
    flat = curve.to_affine_host(wins)
    assert [fh.g1_combine_windows(flat[j * W:(j + 1) * W], curve.WINDOW_BITS)
            for j in range(jobs)] == want
    assert curve.to_affine_host_single(
        curve.pmap(lambda t: t.reshape(-1, curve.fp.NWORDS)[0], out)) \
        == want[0]
    with pytest.raises(ValueError):
        curve.msm_windows_device(pv, dig[..., :-2, :])


def test_msm_device_and_windows_match_jax():
    """msm_device at n=16 and msm_windows_device at n=8, two MSMs each: the
    JAX package's points and window sums lane for lane."""
    rng = np.random.default_rng(5)
    for n, fn, jfn in ((16, curve.msm_device, jcurve.msm_device),
                       (8, curve.msm_windows_device,
                        jcurve.msm_windows_device)):
        flat = _pts(rng, n, holes=(3,)) + _pts(rng, n)
        scs = [[_scalar(rng) for _ in range(n)] for _ in range(2)]
        dig, arr = _digits(scs)
        got = curve.to_affine_host(fn(_port(flat, (2, n)), dig))
        assert got == jcurve.to_affine_host(
            jax.jit(jfn)(_jax(flat, (2, n)), jnp.asarray(arr)))
        if fn is curve.msm_device:
            assert got == [fh.g1_msm(flat[:n], scs[0]),
                           fh.g1_msm(flat[n:], scs[1])]


@pytest.mark.parametrize("k,n,m", [(2, 8, 2), (3, 16, 2)])
def test_msm_stacked_and_rows_device_match_oracle(k, n, m):
    rng = np.random.default_rng(100 + n)
    rows = [_pts(rng, n, holes=(b,)) for b in range(k)]
    pv = _port(sum(rows, []), (k, n))
    scs = [[[_scalar(rng) for _ in range(n)] for _ in range(k)]
           for _ in range(m)]
    dig, _ = _digits(sum(scs, []))
    out = curve.msm_stacked_device(pv, dig.reshape(m, k, 2 * n, W))
    assert tuple(out.x.shape) == (m, k, curve.fp.NWORDS)
    assert curve.to_affine_host(out) == [
        fh.g1_msm(rows[b], scs[j][b]) for j in range(m) for b in range(k)]
    picks = [k - 1, 0, k - 1]
    rdig, _ = _digits([scs[0][b] for b in picks])
    assert curve.to_affine_host(curve.msm_rows_device(pv, rdig, picks)) == [
        fh.g1_msm(rows[b], scs[0][b]) for b in picks]
    flat = curve.to_affine_host(curve.msm_rows_windows_device(pv, rdig, picks))
    assert [fh.g1_combine_windows(flat[t * W:(t + 1) * W], curve.WINDOW_BITS)
            for t in range(len(picks))] == [
        fh.g1_msm(rows[b], scs[0][b]) for b in picks]


def test_msm_stacked_and_rows_device_match_jax():
    """msm_stacked_device at k=2, n=8, m=2 and msm_rows_device at k=2,
    n=16: the JAX package's points for every (job, base) pair."""
    rng = np.random.default_rng(77)
    flat = _pts(rng, 8, holes=(2,)) + _pts(rng, 8)
    scs = [[_scalar(rng) for _ in range(8)] for _ in range(4)]
    dig, arr = _digits(scs)
    got = curve.msm_stacked_device(_port(flat, (2, 8)),
                                   dig.reshape(2, 2, 16, W))
    assert curve.to_affine_host(got) == jcurve.to_affine_host(
        jax.jit(jcurve.msm_stacked_device)(_jax(flat, (2, 8)),
                                           jnp.asarray(arr.reshape(2, 2, 16,
                                                                   W))))
    flat = _pts(rng, 16) + _pts(rng, 16, holes=(0, 15))
    scs = [[_scalar(rng) for _ in range(16)] for _ in range(3)]
    dig, arr = _digits(scs)
    rows = (1, 0, 1)
    got = curve.msm_rows_device(_port(flat, (2, 16)), dig, rows)
    want = jcurve.to_affine_host(jax.jit(
        jcurve.msm_rows_device, static_argnums=2)(
            _jax(flat, (2, 16)), jnp.asarray(arr), rows))
    assert curve.to_affine_host(got) == want
    assert want == [fh.g1_msm(flat[16 * b:16 * b + 16], s)
                    for b, s in zip(rows, scs)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_msm_entry_points_match_oracle(cuda_device):
    """On the card (kernels B1, B2, B3, B5, B6 and glv_recode): every
    entry point at k=3, n=64, m=2 against the oracle, and a launch of each
    counted; the digits recoded by the glv_recode kernel, equal to the
    host's; each host entry point (msm_many, DeviceVec.msm and its fold,
    msm, msm_with_static, batch_scalar_mul) recodes its scalars in one
    glv_recode launch."""
    from go_curdleproofs_tpu_torch.ops import kernels

    rng = np.random.default_rng(64)
    k, n, m = 3, 64, 2
    rows = [_pts(rng, n, holes=(b,)) for b in range(k)]
    pv = curve.pmap(lambda t: t.to(cuda_device), _port(sum(rows, []), (k, n)))
    scs = [[[_scalar(rng) for _ in range(n)] for _ in range(k)]
           for _ in range(m)]
    kernels.reset_launches()
    dig = curve.recode([(r, 0, n) for r in sum(scs, [])], cuda_device,
                       bases=False).reshape(m * k, 2 * n, W)
    assert kernels.launches["glv_recode"] == 1
    assert torch.equal(dig.cpu(), _digits(sum(scs, []))[0])
    want = [fh.g1_msm(rows[b], scs[j][b]) for j in range(m) for b in range(k)]
    kernels.reset_launches()
    out = curve.msm_stacked_device(pv, dig.reshape(m, k, 2 * n, W))
    assert curve.to_affine_host(out) == want
    assert kernels.launches["msm_select_reduce"] == 1
    assert kernels.launches["windowed_combine"] == 1
    assert curve.to_affine_host(curve.msm_device(pv, dig[:k])) == want[:k]
    wins = curve.to_affine_host(curve.msm_windows_device(pv, dig[:k]))
    assert [fh.g1_combine_windows(wins[b * W:(b + 1) * W], curve.WINDOW_BITS)
            for b in range(k)] == want[:k]
    assert curve.to_affine_host(
        curve.msm_rows_device(pv, dig[k:k + 2], (0, 1))) == want[k:k + 2]

    # the host entry points, each one glv_recode launch
    flat = sum(rows, [])
    sc = [_scalar(rng) for _ in range(n)]
    sv = curve.StackedVec.from_affine(rows, device=cuda_device)
    dv = curve.DeviceVec.from_affine(rows[1], device=cuda_device)
    gamma = _scalar(rng)
    long_sc = scs[0][0] + scs[0][1] + sc[:22]
    for what, run, expect in (
            ("msm_many", lambda: sv.msm_many([[(0, sc[:5], 3)],
                                              [(2, sc, 0), (1, sc[:9], 1)]]),
             [fh.g1_msm(rows[0][3:8], sc[:5]),
              fh.g1_add(fh.g1_msm(rows[2], sc), fh.g1_msm(rows[1][1:10],
                                                          sc[:9]))]),
            ("DeviceVec.msm", lambda: dv.msm(sc[:7], offset=2),
             fh.g1_msm(rows[1][2:9], sc[:7])),
            ("msm", lambda: curve.msm(flat[:150], long_sc,
                                      device=cuda_device),
             fh.g1_msm(flat[:150], long_sc)),
            ("msm_with_static", lambda: curve.msm_with_static(
                sv, sc[:40], flat[70:100], scs[1][2][:30]),
             fh.g1_add(fh.g1_msm(rows[0][:40], sc[:40]),
                       fh.g1_msm(flat[70:100], scs[1][2][:30]))),
            ("batch_scalar_mul", lambda: curve.batch_scalar_mul(
                flat[:5], sc[:5], device=cuda_device),
             [fh.g1_mul(p, s) for p, s in zip(flat[:5], sc[:5])]),
            ("DeviceVec.fold", lambda: dv.fold(gamma).to_affine(),
             [fh.g1_add(rows[1][i], fh.g1_mul(rows[1][i + n // 2], gamma))
              for i in range(n // 2)])):
        kernels.reset_launches()
        assert run() == expect, what
        assert kernels.launches["glv_recode"] == 1, what
