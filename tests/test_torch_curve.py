"""The port's G1 layer and MSMs (go_curdleproofs_tpu_torch/ops/curve.py)
against the host oracle and the JAX package's curve layer, by affine value
(exact)."""

import numpy as np
import pytest
import torch

from go_curdleproofs_tpu.models import curdleproof as jcurdleproof
from go_curdleproofs_tpu.ops import compress_dev as jcompress
from go_curdleproofs_tpu.ops import curve as jcurve
from go_curdleproofs_tpu.ops import field_backend as jfp
from go_curdleproofs_tpu.utils import codec as hcodec
from go_curdleproofs_tpu.utils import field_host as fh
from go_curdleproofs_tpu_torch import convert
from go_curdleproofs_tpu_torch.ops import compress_dev, curve

torch.set_num_threads(1)
CPU = torch.device("cpu")
P = fh.P


def _scalar(rng):
    return int.from_bytes(rng.bytes(32), "little") % fh.R


def _pts(rng, n):
    return [fh.g1_mul(fh.G1_GEN, _scalar(rng) % (fh.R - 1) + 1)
            for _ in range(n)]


def test_point_ops_match_oracle_and_jax():
    """Complete add/double on infinity, doubling-through-add and inverse
    pairs; the JAX package's plain-XLA formulas give the same points."""
    rng = np.random.default_rng(42)
    pts, qts = _pts(rng, 8), _pts(rng, 8)
    pts[0] = None
    qts[1] = None
    pts[2] = qts[2] = None
    qts[3] = pts[3]
    qts[4] = (pts[4][0], (P - pts[4][1]) % P)
    pv = curve.from_affine_host(pts, device=CPU)
    qv = curve.from_affine_host(qts, device=CPU)
    jp, jq = jcurve.from_affine_host(pts), jcurve.from_affine_host(qts)

    got = curve.to_affine_host(curve.add(pv, qv))
    assert got == [fh.g1_add(p, q) for p, q in zip(pts, qts)]
    assert got == jcurve.to_affine_host(jcurve.add(jp, jq))
    got = curve.to_affine_host(curve.double(pv))
    assert got == [fh.g1_add(p, p) for p in pts]
    assert got == jcurve.to_affine_host(jcurve.double(jp))
    assert curve.to_affine_host(curve.neg(pv)) == [fh.g1_neg(p) for p in pts]


def test_batch_scalar_mul_and_msm_match_oracle():
    rng = np.random.default_rng(13)
    pts = _pts(rng, 8)
    pts[2] = None
    scs = [_scalar(rng) for _ in range(8)]
    scs[3] = 0
    assert curve.batch_scalar_mul(pts, scs, device=CPU) == [
        fh.g1_mul(p, s) if p else None for p, s in zip(pts, scs)]
    assert curve.msm(pts, scs, device=CPU) == fh.g1_msm(
        [p for p in pts if p], [s for p, s in zip(pts, scs) if p])


@pytest.mark.parametrize("n_static,n_dyn", [(12, 5), (12, 40)])
def test_msm_with_static_matches_jax_and_oracle(n_static, n_dyn):
    rng = np.random.default_rng(n_dyn)
    static_pts, dyn_pts = _pts(rng, n_static), _pts(rng, n_dyn)
    st_sc = [_scalar(rng) for _ in range(n_static)]
    dyn_sc = [_scalar(rng) for _ in range(n_dyn)]
    sv = curve.StackedVec.from_affine([static_pts], device=CPU,
                                      pad_to=n_static)
    got = curve.msm_with_static(sv, st_sc, dyn_pts, dyn_sc)
    assert got == fh.g1_add(fh.g1_msm(static_pts, st_sc),
                            fh.g1_msm(dyn_pts, dyn_sc))
    jsv = jcurve.StackedVec.from_affine([static_pts], pad_to=n_static)
    assert got == jcurve.msm_with_static(jsv, st_sc, dyn_pts, dyn_sc)


def test_msm_with_static_identity_cancels():
    rng = np.random.default_rng(8)
    static_pts = _pts(rng, 8)
    sv = curve.StackedVec.from_affine([static_pts], device=CPU, pad_to=8)
    k = _scalar(rng) % (fh.R - 1) + 1
    c = fh.g1_msm(static_pts, [k] * 8)
    assert curve.msm_with_static(sv, [k] * 8, [c], [fh.R - 1]) is None
    # no dynamic points at all: the static row alone
    assert curve.msm_with_static(sv, [k] * 8, [], []) == c


def test_msm_with_static_negative_and_unreduced_scalars():
    """The accumulator bumps scalars unreduced and negative; digits take
    them mod r first (tests/test_msm_combined.py:43-53)."""
    rng = np.random.default_rng(3)
    static_pts, dyn_pts = _pts(rng, 8), _pts(rng, 3)
    sv = curve.StackedVec.from_affine([static_pts], device=CPU, pad_to=8)
    st_sc = [_scalar(rng) for _ in range(8)]
    dyn_sc = [-5, fh.R * 3 + 7, _scalar(rng) << 300]
    got = curve.msm_with_static(sv, st_sc, dyn_pts, dyn_sc)
    assert got == fh.g1_add(fh.g1_msm(static_pts, st_sc),
                            fh.g1_msm(dyn_pts, [s % fh.R for s in dyn_sc]))
    jsv = jcurve.StackedVec.from_affine([static_pts], pad_to=8)
    assert got == jcurve.msm_with_static(jsv, st_sc, dyn_pts, dyn_sc)


def test_convert_takes_over_jax_crs_table():
    """The JAX package's cached CRS multiples table [9, 1, 2n] crosses to
    the port: the same points as the port's own table build, and a working
    static row for msm_with_static."""
    rng = np.random.default_rng(21)
    gh = _pts(rng, 16)                                   # Gs (12) | Hs (4)
    jtab = jcurve.StackedVec.from_affine([gh], pad_to=16).table()
    ptab = convert.pointvec_from_jax(*(np.asarray(c.limbs) for c in jtab),
                                     device=CPU)
    assert tuple(ptab.x.shape) == (9, 1, 32, 12)
    sv = curve.StackedVec.from_affine([gh], device=CPU, pad_to=16)
    assert curve.to_affine_host(ptab) == curve.to_affine_host(sv.table())
    assert curve.to_affine_host(ptab) == jcurve.to_affine_host(jtab)

    sv._table = ptab
    sc = [_scalar(rng) for _ in range(16)]
    dyn = _pts(rng, 2)
    dsc = [_scalar(rng) for _ in range(2)]
    assert curve.msm_with_static(sv, sc, dyn, dsc) == fh.g1_add(
        fh.g1_msm(gh, sc), fh.g1_msm(dyn, dsc))


# -- the prover's device API ----------------------------------------------------

def test_compress_matches_codec_and_jax():
    """compress / compress_xy byte-exact with codec.g1_to_bytes and the JAX
    package's compress_dev, on projective (Z != 1) points, an infinity and
    both y signs; to_affine_host_xy gives the affine points back."""
    rng = np.random.default_rng(31)
    pts = _pts(rng, 7)
    pts[2] = None
    pv = curve.from_affine_host(pts, device=CPU)
    pv = curve.add(pv, pv)                      # Z != 1
    want_pts = [fh.g1_add(p, p) for p in pts]
    blobs = bytes(compress_dev.compress(pv).numpy().tobytes())
    assert [blobs[48 * i:48 * i + 48] for i in range(7)] == \
        [hcodec.g1_to_bytes(p) for p in want_pts]
    assert {b[0] & 0xE0 for b in map(hcodec.g1_to_bytes, want_pts)} == \
        {0x80, 0xA0, 0xC0}
    rows = compress_dev.compress_xy(pv)
    assert rows.dtype == torch.uint8 and tuple(rows.shape) == (7, 96)
    jp = jcurve.from_affine_host(pts)
    jrows = np.asarray(jcompress.compress_xy(jcurve.add(jp, jp)))
    assert (rows.numpy() == jrows.astype(np.uint8)).all()
    assert [compress_dev.decode_xy_host(r) for r in rows.numpy()] == want_pts
    assert curve.to_affine_host_xy(pv) == want_pts


def _msm_jobs(rng, n):
    a, b, c = ([_scalar(rng) for _ in range(n)] for _ in range(3))
    b[0] = 0                                            # a zero scalar
    half = n // 2
    return [[(0, a, 0)],                                # whole row
            [(1, b[:half], half)],                      # upper half at offset
            [(0, a[:half], 0), (1, c, 0)],              # two terms, one owner
            [(1, [0] * n, 0)],                          # all-zero -> infinity
            []]                                         # no term -> infinity


def test_msm_many_matches_oracle_and_jax():
    rng = np.random.default_rng(32)
    n = 8
    vecs = [_pts(rng, n), _pts(rng, n)]
    vecs[0][3] = None                                   # an infinity base
    jobs = _msm_jobs(rng, n)
    sv = curve.StackedVec.from_affine(vecs, device=CPU)
    assert (sv.k, sv.width, sv.n_valid) == (2, 8, 8)
    got = sv.msm_many(jobs)
    want = []
    for terms in jobs:
        acc = None
        for (row, sc, off) in terms:
            acc = fh.g1_add(acc, fh.g1_msm(
                [p for p in vecs[row][off:off + len(sc)]],
                [s if p else 0 for p, s in
                 zip(vecs[row][off:off + len(sc)], sc)]))
        want.append(acc)
    assert got == want
    assert got[3] is None and got[4] is None
    assert got == jcurve.StackedVec.from_affine(vecs).msm_many(jobs[:4]) \
        + [None]
    with pytest.raises(ValueError):
        sv.msm_many([[(0, [1] * 5, 6)]])                # runs past the row


def test_folded_bases_folds_and_diags_match_oracle_and_jax():
    """Two recorded folds and a diagonal rescale stay scalar-side: the MSMs
    equal those over the honestly folded, rescaled bases."""
    rng = np.random.default_rng(33)
    n = 8
    g = _pts(rng, n)
    diag = [_scalar(rng) for _ in range(n)]
    g1, g2 = _scalar(rng), _scalar(rng)
    g1b, g2b = _scalar(rng), _scalar(rng)

    def fold(vec, gamma):
        h = len(vec) // 2
        return [fh.g1_add(vec[i], fh.g1_mul(vec[i + h], gamma))
                for i in range(h)]

    row0 = fold(fold(g, g1), g2)
    row1 = fold(fold([fh.g1_mul(p, d) for p, d in zip(g, diag)], g1b), g2b)
    sc = [_scalar(rng), _scalar(rng)]
    jobs = [[(0, sc, 0)], [(1, sc, 0)], [(0, sc[:1], 1), (1, sc[1:], 0)]]
    want = [fh.g1_msm(row0, sc), fh.g1_msm(row1, sc),
            fh.g1_add(fh.g1_mul(row0[1], sc[0]), fh.g1_mul(row1[0], sc[1]))]

    sv = curve.StackedVec.from_affine([g], device=CPU, pad_to=n)
    fb = curve.FoldedBases(sv, rows=[0, 0], diags={1: diag})
    assert (fb.k, fb.n_valid) == (2, 8)
    fb = fb.fold([g1, g1b]).fold([g2, g2b])
    assert fb.n_valid == 2
    assert fb.msm_many(jobs) == want
    jfb = jcurve.FoldedBases(jcurve.StackedVec.from_affine([g], pad_to=n),
                             rows=[0, 0], diags={1: diag})
    assert jfb.fold([g1, g1b]).fold([g2, g2b]).msm_many(jobs) == want
    # one gamma for every row
    fb1 = curve.FoldedBases.from_affine([g], device=CPU).fold(g1)
    assert fb1.msm_many([[(0, sc + sc, 0)]]) == [fh.g1_msm(fold(g, g1),
                                                           sc + sc)]


def test_folded_bases_skips_none_diagonal_entries():
    """A None entry of a diagonal leaves its lane as it is, as the JAX
    package's FoldedBases does: diags {0: [2, None]} gives 2 s0 and s1."""
    rng = np.random.default_rng(36)
    g = _pts(rng, 2)
    s0, s1 = _scalar(rng), _scalar(rng)
    sv = curve.StackedVec.from_affine([g], device=CPU)
    fb = curve.FoldedBases(sv, rows=[0], diags={0: [2, None]})
    assert fb._expand(0, [s0, s1], 0)[:2] == [2 * s0 % fh.R, s1]
    want = fh.g1_add(fh.g1_mul(g[0], 2 * s0 % fh.R), fh.g1_mul(g[1], s1))
    assert fb.msm_many([[(0, [s0, s1], 0)]]) == [want]
    jfb = jcurve.FoldedBases(jcurve.StackedVec.from_affine([g]), rows=[0],
                             diags={0: [2, None]})
    assert jfb.msm_many([[(0, [s0, s1], 0)]]) == [want]


def test_wide_msm_runs_in_rows_of_4096(monkeypatch):
    """Above 8,192 bases an MSM takes rows of 4,096 bases of one table
    (8,200 bases: 3 rows, 24,576 GLV lanes where one row padded to a power
    of two took 32,768); every row's window sums are added before the one
    Horner. Up to 8,192 bases (every ELL=124 path) one row as before."""
    assert curve._dynamic_layout(590) == (1, 1024)
    assert curve._dynamic_layout(8192) == (1, 8192)
    assert curve._dynamic_layout(8193) == (3, 4096)
    assert curve._dynamic_layout(17000) == (5, 4096)
    seen = []

    def no_table(self):
        seen.append(tuple(self.pv.x.shape[:2]))
        return None

    def windows(table, digits, rows):
        seen.append((tuple(digits.shape), list(rows)))
        return curve.infinity((len(rows), curve.NUM_WINDOWS), device=CPU)

    monkeypatch.setattr(curve.StackedVec, "table", no_table)
    monkeypatch.setattr(curve, "msm_rows_windows_from_table", windows)
    pts = [fh.G1_GEN] * 8200
    sums = curve._dynamic_windows(pts, list(range(8200)), CPU)
    assert seen == [(3, 4096), ((3, 2 * 4096, curve.NUM_WINDOWS), [0, 1, 2])]
    assert tuple(sums.x.shape) == (1, curve.NUM_WINDOWS, 12)
    assert 2 * 3 * 4096 == 24576 < 2 * curve._pad_pow2(8200) == 32768


@pytest.mark.slow
def test_wide_msm_rows_match_oracle():
    """An MSM of 8,200 bases (three rows) on the plain versions against
    the host oracle."""
    rng = np.random.default_rng(37)
    n = 8200
    p, step = _pts(rng, 2)
    pts = []
    for _ in range(n):
        pts.append(p)
        p = fh.g1_add(p, step)
    scs = [_scalar(rng) for _ in range(n)]
    assert curve.msm(pts, scs, device=CPU) == fh.g1_msm(pts, scs)


def test_msm_batch_matches_oracle_and_jax():
    rng = np.random.default_rng(34)
    jobs = [(_pts(rng, 3), [_scalar(rng) for _ in range(3)]),
            (_pts(rng, 5), [_scalar(rng) for _ in range(5)]),
            ([None, fh.G1_GEN], [7, 0])]
    got = curve.msm_batch(jobs, device=CPU)
    assert got == [fh.g1_msm(*jobs[0]), fh.g1_msm(*jobs[1]), None]
    assert got == jcurve.msm_batch(jobs)
    assert curve.msm_batch([], device=CPU) == []
    with pytest.raises(ValueError):
        curve.msm_batch([(jobs[0][0], [1])], device=CPU)


def test_convert_carries_pointvec_and_crs_both_ways():
    """A JAX PointVec crosses by canonical coordinates (its to_ints) and
    comes back the same; a CRS crosses as affine ints."""
    rng = np.random.default_rng(35)
    pts = _pts(rng, 6)
    pts[1] = None
    jp = jcurve.add(jcurve.from_affine_host(pts), jcurve.from_affine_host(pts))
    planes = [np.array(jfp.to_ints(c), dtype=object) for c in jp]
    pv = convert.pointvec_from_ints(*planes, (2, 3), device=CPU)
    assert tuple(pv.x.shape) == (2, 3, 12)
    assert curve.to_affine_host(pv) == jcurve.to_affine_host(jp)
    back = convert.pointvec_to_ints(pv)
    assert all(b.shape == (2, 3) and b.reshape(-1).tolist() == p.tolist()
               for b, p in zip(back, planes))

    gs, hs = _pts(rng, 4), _pts(rng, 4)
    h, gt, gu = _pts(rng, 3)
    crs = convert.crs_from_affine(gs, hs, h, gt, gu, gs[0], None)
    assert (crs.gs, crs.hs, crs.h, crs.gt, crs.gu, crs.gsum, crs.hsum) == \
        (gs, hs, h, gt, gu, gs[0], None)
    jcrs = jcurdleproof.CRS(**convert.crs_to_affine(crs))
    assert convert.crs_from_affine(**vars(jcrs)) == crs
