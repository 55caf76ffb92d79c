"""Physical base folding of the port (ops/curve.py: `fold_device`,
`StackedVec.fold`, `DeviceVec`) against the JAX package's and the host
oracle, by affine value lane for lane (exact), with width and n_valid;
one JAX compile a function."""

import numpy as np
import pytest
import torch

from go_curdleproofs_tpu.ops import curve as jcurve
from go_curdleproofs_tpu.utils import field_host as fh
from go_curdleproofs_tpu_torch.ops import curve, glv, kernels

torch.set_num_threads(1)
CPU = torch.device("cpu")
W = curve.NUM_WINDOWS


def _scalar(rng):
    return int.from_bytes(rng.bytes(32), "little") % fh.R


def _pts(rng, n, holes=()):
    return [None if i in holes else fh.g1_mul(fh.G1_GEN, _scalar(rng) or 1)
            for i in range(n)]


def _fold_oracle(pts, gamma):
    h = len(pts) // 2
    return [fh.g1_add(pts[i], fh.g1_mul(pts[i + h], gamma)) for i in range(h)]


@pytest.mark.parametrize("n_valid", [8, 7])
def test_device_vec_matches_jax(n_valid):
    """DeviceVec at width 8: msm at an offset, two chained folds (an odd
    n_valid drops its last lane), every lane by affine value, width and
    n_valid as the JAX package's (tests/test_curve.py:65-84)."""
    rng = np.random.default_rng(n_valid)
    pts = _pts(rng, n_valid, holes=(1,))
    dv = curve.DeviceVec.from_affine(pts, device=CPU)
    jdv = jcurve.DeviceVec.from_affine(pts)
    assert (dv.width, dv.n_valid) == (jdv.width, jdv.n_valid) == (8, n_valid)
    sc = [_scalar(rng) for _ in range(3)]
    got = dv.msm(sc, offset=2)
    assert got == jdv.msm(sc, offset=2) == fh.g1_msm(pts[2:5], sc)
    want = pts
    for gamma in (_scalar(rng), _scalar(rng)):
        dv, jdv = dv.fold(gamma), jdv.fold(gamma)
        want = _fold_oracle(want, gamma)
        assert (dv.width, dv.n_valid) == (jdv.width, jdv.n_valid) \
            == (8, len(want))
        lanes = curve.to_affine_host(dv.pv)
        assert lanes == jcurve.to_affine_host(jdv.pv)
        assert lanes == want + [None] * (8 - len(want))
        assert dv.to_affine() == want
    assert dv.msm([5], offset=0) == fh.g1_mul(want[0], 5)


@pytest.mark.parametrize("n_valid", [8, 7])
def test_fold_device_takes_the_jax_digits(n_valid):
    """fold_device called as the JAX package calls it (one gamma's digits
    tiled over the whole width) equals the JAX package's fold."""
    rng = np.random.default_rng(40 + n_valid)
    pts = _pts(rng, n_valid, holes=(5,))
    gamma = _scalar(rng)
    h = n_valid // 2
    tiled = np.tile(glv.scalars_to_digits_glv([gamma]), (8, 1))
    got = curve.fold_device(curve.DeviceVec.from_affine(pts, device=CPU).pv,
                            torch.from_numpy(tiled), h)
    want = jcurve.DeviceVec.from_affine(pts).fold(gamma)
    assert curve.to_affine_host(got) == jcurve.to_affine_host(want.pv)
    with pytest.raises(ValueError):
        curve.fold_device(curve.DeviceVec.from_affine(pts, device=CPU).pv,
                          torch.from_numpy(tiled[:2 * h - 2]), h)


@pytest.mark.parametrize("n_valid", [8, 7])
def test_stacked_vec_fold_matches_jax(n_valid):
    """StackedVec.fold at [2, 8] with a gamma per row and with one gamma:
    the JAX package's lanes, width and n_valid; the folded vector builds
    its own table, so its msm_many is the MSM over the folded bases."""
    rng = np.random.default_rng(60 + n_valid)
    rows = [_pts(rng, n_valid, holes=(0,)), _pts(rng, n_valid)]
    sv = curve.StackedVec.from_affine(rows, device=CPU)
    jsv = jcurve.StackedVec.from_affine(rows)
    gammas = [_scalar(rng), _scalar(rng)]
    sv.table()
    f, jf = sv.fold(gammas), jsv.fold(gammas)
    assert (f.k, f.width, f.n_valid) == (2, jf.width, jf.n_valid) \
        == (2, 8, n_valid // 2)
    lanes = curve.to_affine_host(f.pv)
    assert lanes == jcurve.to_affine_host(jf.pv)
    want = [_fold_oracle(r, g) for r, g in zip(rows, gammas)]
    h = n_valid // 2
    assert lanes == sum((w + [None] * (8 - h) for w in want), [])
    assert f._table is None
    sc = [_scalar(rng) for _ in range(h)]
    assert f.msm_many([[(1, sc, 0)]]) == [fh.g1_msm(want[1], sc)]
    one = sv.fold(gammas[0])
    assert curve.to_affine_host(one.pv)[:h] == want[0]
    assert curve.to_affine_host(one.pv)[8:8 + h] == _fold_oracle(rows[1],
                                                                 gammas[0])
    with pytest.raises(ValueError):
        sv.fold(gammas + [1])


def test_fold_down_to_one_point_and_empty():
    """Rounds from 16 down to n_valid 1, then 0: every lane infinity."""
    rng = np.random.default_rng(9)
    pts = _pts(rng, 16)
    dv = curve.DeviceVec.from_affine(pts, device=CPU)
    want = pts
    while dv.n_valid > 1:
        g = _scalar(rng)
        dv, want = dv.fold(g), _fold_oracle(want, g)
        assert dv.to_affine() == want
    assert dv.width == 16 and dv.n_valid == 1
    last = dv.fold(3)
    assert last.n_valid == 0 and curve.to_affine_host(last.pv) == [None] * 16
    with pytest.raises(ValueError):
        dv.msm([1] * 17)


def test_fold_launches_only_the_half_it_needs():
    """A fold of width 16 at h = 8 multiplies 8 lanes: the Horner kernel
    sees [33, 16] GLV lanes, not the whole width's 32."""
    seen = []
    orig = kernels.windowed_combine

    def spy(sel):
        seen.append(tuple(sel.x.shape))
        return orig(sel)

    rng = np.random.default_rng(3)
    dv = curve.DeviceVec.from_affine(_pts(rng, 16), device=CPU)
    kernels.windowed_combine = spy
    try:
        dv.fold(_scalar(rng))
    finally:
        kernels.windowed_combine = orig
    assert seen == [(W, 16, curve.fp.NWORDS)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_folds_match_plain_and_oracle(cuda_device):
    """On the card: DeviceVec folded from 64 lanes down to one point and
    StackedVec.fold at [2, 64], lane for lane as the plain path on the CPU
    and as the oracle."""
    rng = np.random.default_rng(640)
    pts = _pts(rng, 63, holes=(4,))
    dv = curve.DeviceVec.from_affine(pts, device=cuda_device)
    cv = curve.DeviceVec.from_affine(pts, device=CPU)
    want = pts
    while dv.n_valid > 1:
        g = _scalar(rng)
        dv, cv, want = dv.fold(g), cv.fold(g), _fold_oracle(want, g)
        lanes = curve.to_affine_host(dv.pv)
        assert lanes == curve.to_affine_host(cv.pv)
        assert lanes[:dv.n_valid] == want
        sc = [_scalar(rng) for _ in want]
        assert dv.msm(sc) == fh.g1_msm(want, sc)
    rows = [_pts(rng, 64), _pts(rng, 64, holes=(63,))]
    gammas = [_scalar(rng), _scalar(rng)]
    f = curve.StackedVec.from_affine(rows, device=cuda_device).fold(gammas)
    assert curve.to_affine_host(f.pv) == sum(
        (_fold_oracle(r, g) + [None] * 32 for r, g in zip(rows, gammas)), [])
