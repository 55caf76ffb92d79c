"""The redesigned MSM kernels of the port (windowed_combine and
msm_select_reduce in go_curdleproofs_tpu_torch/ops/kernels.py): how the wide
phase is split over blocks, and the inputs that hit the corners of the
complete point formulas.

The CUDA kernels run only on a card. Here the wrapper's split function is
checked as the pure function it is, and the corner inputs go through the
plain versions (which the kernels are held against on the card) against the
host oracle and, at one small shape each, against the JAX package's Pallas
kernels in interpret mode, by affine value, tolerance 0 (integers). The
`cuda` tests give the same inputs to the kernels on a card
(python -m pytest -m cuda tests/test_torch_msm_redesign.py)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_curdleproofs_tpu.ops import curve as jcurve
from go_curdleproofs_tpu.ops import rns_kernels
from go_curdleproofs_tpu.ops.field_backend import Fp as JFp
from go_curdleproofs_tpu_torch import convert
from go_curdleproofs_tpu_torch.ops import curve, fp, kernels
from go_curdleproofs_tpu_torch.utils import field_host as fh

torch.set_num_threads(1)
CPU = torch.device("cpu")
W = curve.NUM_WINDOWS

# (m, n2) of every msm_select_reduce launch of a verify, a host prove and a
# device prove at ELL=124: 1-6 jobs over the 256-lane CRS rows, the
# 512-lane tracker batch, the verifier's 2048-lane dynamic row
MAIN_PATH_SHAPES = [(m, 256) for m in range(1, 7)] + [(1, 512), (1, 2048)]


def _rand_point(rng):
    return fh.g1_mul(fh.G1_GEN,
                     int.from_bytes(rng.bytes(32), "little") % (fh.R - 1) + 1)


# -- (a) the split of one job's lanes over blocks ------------------------------

@pytest.mark.parametrize("m,n2", MAIN_PATH_SHAPES)
def test_msm_split_on_main_path_shapes(m, n2):
    s = kernels._msm_split(m, n2, W)
    assert 1 <= s <= kernels._SPLIT_MAX
    if m >= 3:
        assert s == 1       # most of the provers' launches: one kernel
    # never more blocks than the lanes allow, never more than one an SM
    assert s == 1 or n2 // s >= kernels._SPLIT_MIN_LANES
    assert s == 1 or W * m * s <= kernels._SM_COUNT
    # and no fewer than that allows
    assert (W * m * (s + 1) > kernels._SM_COUNT
            or n2 // (s + 1) < kernels._SPLIT_MIN_LANES)


def test_msm_split_fills_the_card_at_the_widest_shape():
    s = kernels._msm_split(1, 2048, W)
    assert kernels._SM_COUNT - W < W * s <= kernels._SM_COUNT
    assert 2048 // s >= kernels._SPLIT_MIN_LANES


@pytest.mark.parametrize("m,n2,w", [(1, 1, 1), (1, 8, 33), (40, 256, 33),
                                    (1, 1 << 16, 33), (1, 200, 1)])
def test_msm_split_stays_in_range_off_the_main_path(m, n2, w):
    s = kernels._msm_split(m, n2, w)
    assert 1 <= s <= kernels._SPLIT_MAX
    assert s == 1 or n2 // s >= kernels._SPLIT_MIN_LANES


def test_msm_split_argument_is_checked_on_every_device():
    table, digits, _ = _msm_corner_case(np.random.default_rng(1), n_win=2)
    for bad in (0, -1, kernels._SPLIT_MAX + 1):
        with pytest.raises(ValueError):
            kernels.msm_select_reduce(table, digits, _split=bad)
    a = kernels.msm_select_reduce(table, digits, _split=2)
    b = kernels.msm_select_reduce_plain(table, digits)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_every_cuda_source_is_hashed_for_the_rebuild():
    """A changed header must rebuild the libraries: every file of
    ops/csrc/ is among the hashed sources, the cooperative point
    operations included."""
    csrc = Path(kernels.__file__).parent / "csrc"
    on_disk = {p.name for p in csrc.iterdir() if p.suffix in (".cu", ".cuh")}
    assert on_disk == set(kernels._SOURCES)
    assert "point_coop.cuh" in on_disk
    assert '#include "point_coop.cuh"' in (csrc / "kernels.cu").read_text()


# -- (b) corner inputs through the plain versions ------------------------------

COMBINE_CORNERS = ["all_infinity", "add_is_doubling", "sum_is_infinity",
                   "infinity_then_points", "random_a", "random_b",
                   "last_window_only", "random_c"]


def _combine_corner_columns(rng):
    """Eight rows of W window points (MSB first), named by COMBINE_CORNERS:
    a row of infinities; a row whose accumulator P meets sel = 16 P after
    its four doublings (the add is a doubling); the same with -16 P (the sum
    is infinity, and the row goes on from there); and rows with infinities
    at the head, in between, and everywhere but the last window."""
    p, q = _rand_point(rng), _rand_point(rng)
    p16 = fh.g1_mul(p, 16)
    cols = {name: [None] * W for name in COMBINE_CORNERS}
    cols["add_is_doubling"][3] = p
    cols["add_is_doubling"][4] = p16
    cols["sum_is_infinity"][3] = p
    cols["sum_is_infinity"][4] = fh.g1_neg(p16)
    cols["sum_is_infinity"][9] = q
    cols["infinity_then_points"][W // 2:] = [_rand_point(rng)
                                             for _ in range(W - W // 2)]
    for name in ("random_a", "random_b", "random_c"):
        col = [_rand_point(rng) for _ in range(W)]
        for i in rng.choice(W, size=4, replace=False):
            col[int(i)] = None
        cols[name] = col
    cols["last_window_only"][W - 1] = q
    return [cols[name] for name in COMBINE_CORNERS]


def _combine_sel(cols, device):
    """[W, rows, 12] per coordinate from rows of W window points."""
    rows = len(cols)
    flat = [cols[r][w] for w in range(W) for r in range(rows)]
    return curve.pmap(lambda t: t.reshape(W, rows, fp.NWORDS).contiguous(),
                      curve.from_affine_host(flat, device=device))


@pytest.fixture(scope="module")
def combine_corners():
    cols = _combine_corner_columns(np.random.default_rng(60))
    got = curve.to_affine_host(
        kernels.windowed_combine(_combine_sel(cols, CPU)))
    return cols, got


@pytest.mark.parametrize("row", range(len(COMBINE_CORNERS)),
                         ids=COMBINE_CORNERS)
def test_windowed_combine_plain_corner_matches_oracle(combine_corners, row):
    cols, got = combine_corners
    assert got[row] == fh.g1_combine_windows(cols[row], 4)
    if COMBINE_CORNERS[row] == "all_infinity":
        assert got[row] is None
    if COMBINE_CORNERS[row] == "add_is_doubling":
        assert got[row] == fh.g1_mul(cols[row][3], 32 * 16 ** (W - 5))
    if COMBINE_CORNERS[row] == "sum_is_infinity":
        assert got[row] == fh.g1_mul(cols[row][9], 16 ** (W - 10))


def test_windowed_combine_plain_corners_match_pallas_kernel(combine_corners):
    cols, got = combine_corners
    rows = len(cols)
    flat = [cols[r][w] for w in range(W) for r in range(rows)]
    jp = jcurve.from_affine_host(flat)
    sel_j = tuple(jnp.asarray(np.asarray(c.limbs).reshape(W, rows, -1))
                  for c in jp)
    kout = rns_kernels.windowed_combine(sel_j, (1, 1, 1), W, interpret=True)
    assert got == jcurve.to_affine_host(kout)


def test_windowed_combine_plain_ragged_rows(combine_corners):
    """Seven rows (no multiple of the kernel's 16 rows a block), one row:
    the same sums as in the batch of eight, word for word."""
    cols, got = combine_corners
    full = kernels.windowed_combine(_combine_sel(cols, CPU))
    for rows in (7, 1):
        out = kernels.windowed_combine(_combine_sel(cols[:rows], CPU))
        assert out.x.shape == (rows, fp.NWORDS)
        assert all(torch.equal(u, v[:rows]) for u, v in zip(out, full))


def _msm_corner_case(rng, n_win, m=3, n2=20):
    """A [9, m, n2] table (n2 no multiple of a group of 8, of the 32 groups
    of a block or of a split) over points with an infinity and one point
    in three lanes, with digits [m, n2, n_win] that hit the corners:
    job 0 random with the edge magnitudes; job 1 all zero (every window sum
    is infinity); job 2, window 0: the one point twice with the same digit
    (a partial sum meets itself: the add is a doubling), window 1: with
    opposite digits (the sum is infinity), further windows: a single lane.
    Returns (table, digits, points [m][n2])."""
    pts = [[_rand_point(rng) for _ in range(n2)] for _ in range(m)]
    pts[0][2] = None
    pts[2][5] = pts[2][11] = pts[2][0]
    rows = [curve.from_affine_host(row, device=CPU) for row in pts]
    base = curve.PointVec(*(torch.stack(c) for c in zip(*rows)))   # [m, n2]
    table = curve.pmap(lambda t: t.contiguous(), curve.build_table(base))
    dig = rng.integers(-8, 9, (m, n2, n_win), dtype=np.int32)
    dig[0, :4, 0] = [8, -8, 5, 0]
    dig[1] = 0
    dig[2] = 0
    dig[2, 0, 0] = dig[2, 11, 0] = 3
    if n_win > 1:
        dig[2, 5, 1], dig[2, 11, 1] = 7, -7
    for w in range(2, n_win):
        dig[2, (3 * w) % n2, w] = -(w % 8 + 1)
    return table, torch.from_numpy(dig), pts


def _msm_oracle(pts, digits):
    """Window sums [m * n_win] from the host's group law."""
    out = []
    for j, row in enumerate(pts):
        for w in range(digits.shape[2]):
            acc = None
            for l, p in enumerate(row):
                d = int(digits[j, l, w])
                term = fh.g1_mul(p, abs(d))
                acc = fh.g1_add(acc, fh.g1_neg(term) if d < 0 else term)
            out.append(acc)
    return out


def test_msm_select_reduce_plain_corners_match_oracle():
    n_win = 4
    table, digits, pts = _msm_corner_case(np.random.default_rng(61), n_win)
    got = curve.to_affine_host(kernels.msm_select_reduce(table, digits))
    assert got == _msm_oracle(pts, digits)
    assert got[n_win:2 * n_win] == [None] * n_win          # the all-zero job
    assert got[2 * n_win] == fh.g1_mul(pts[2][0], 6)       # P + P
    assert got[2 * n_win + 1] is None                      # 7 P - 7 P
    # and the window sums, Horner-combined, are the MSM of the scalars that
    # the digits spell
    for j, row in enumerate(pts):
        scalars = [sum(int(d) * 16 ** (n_win - 1 - w)
                       for w, d in enumerate(digits[j, l])) % fh.R
                   for l in range(len(row))]
        live = [(p, s) for p, s in zip(row, scalars) if p is not None]
        assert fh.g1_combine_windows(got[j * n_win:(j + 1) * n_win], 4) \
            == fh.g1_msm([p for p, _ in live], [s for _, s in live])


def test_msm_select_reduce_plain_single_lane_and_job():
    """The smallest shapes: one lane, and one job of one window."""
    rng = np.random.default_rng(62)
    table, digits, pts = _msm_corner_case(rng, n_win=1, m=3, n2=12)
    one = curve.pmap(lambda t: t[:, :1, :1].contiguous(), table)
    d = torch.tensor([[[-8]]], dtype=torch.int32)
    got = curve.to_affine_host(kernels.msm_select_reduce(one, d))
    assert got == [fh.g1_neg(fh.g1_mul(pts[0][0], 8))]
    got = curve.to_affine_host(kernels.msm_select_reduce(table, digits))
    assert got == _msm_oracle(pts, digits)


def test_msm_select_reduce_plain_corners_match_pallas_kernel():
    """Two jobs on one row of the JAX package's own multiples table (GLV
    lanes: 2i = P_i, 2i + 1 = phi(P_i)), with one point in two places, at
    all 33 windows: job 0 random digits; job 1 zero but for window 0 (the
    point twice with one digit), window 1 (opposite digits) and window 2
    (a single lane)."""
    rng = np.random.default_rng(63)
    n = 16
    vec = [_rand_point(rng) for _ in range(n)]
    vec[3] = None
    vec[6] = vec[1]
    sv = jcurve.StackedVec.from_affine([vec])
    n2 = int(sv.table().x.limbs.shape[2])
    digits = rng.integers(-8, 9, (2, n2, W), dtype=np.int32)
    digits[1] = 0
    digits[1, 2, 0] = digits[1, 12, 0] = 4
    digits[1, 2, 1], digits[1, 12, 1] = -8, 8
    digits[1, 5, 2] = -1
    rows = np.array([0, 0], np.int32)
    tab = jcurve.pmap_coords(lambda t: jnp.take(t, rows, axis=1), sv.table())
    wx, wy, wz = rns_kernels.msm_select_reduce(
        (tab.x.limbs, tab.y.limbs, tab.z.limbs), jnp.asarray(digits), 6,
        interpret=True)
    want = jcurve.to_affine_host(
        jcurve.PointVec(JFp(wx, 6), JFp(wy, 6), JFp(wz, 6)))
    ptab = convert.pointvec_from_jax(*(np.asarray(c.limbs) for c in tab),
                                     device=CPU)
    got = curve.to_affine_host(
        kernels.msm_select_reduce(ptab, torch.from_numpy(digits)))
    assert got == want
    assert got[W] == fh.g1_mul(vec[1], 8)
    assert got[W + 1] is None
    assert got[W + 3:] == [None] * (W - 3)


# -- (c) the same inputs through the kernels, on a card ------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_windowed_combine_corners_match_plain(cuda_device):
    cols = _combine_corner_columns(np.random.default_rng(60))
    kernels.reset_launches()
    for rows in (8, 7, 1):
        sel = _combine_sel(cols[:rows], cuda_device)
        got = kernels.windowed_combine(sel)
        torch.cuda.synchronize()
        want = kernels.windowed_combine_plain(sel)
        assert all(torch.equal(u, v) for u, v in zip(got, want))
        assert curve.to_affine_host(got) == [
            fh.g1_combine_windows(c, 4) for c in cols[:rows]]
    assert kernels.launches["windowed_combine"] == 3


@pytest.mark.cuda
def test_cuda_msm_select_reduce_corners_match_plain(cuda_device):
    table, digits, pts = _msm_corner_case(np.random.default_rng(61), W)
    table = curve.pmap(lambda t: t.to(cuda_device), table)
    digits = digits.to(cuda_device)
    want = curve.to_affine_host(kernels.msm_select_reduce_plain(table,
                                                                digits))
    assert want == _msm_oracle(pts, digits.cpu())
    kernels.reset_launches()
    for split in (None, 1, 2, 3, 16):
        first = kernels.msm_select_reduce(table, digits, _split=split)
        again = kernels.msm_select_reduce(table, digits, _split=split)
        torch.cuda.synchronize()
        assert curve.to_affine_host(first) == want
        assert all(torch.equal(u, v) for u, v in zip(first, again))
    assert kernels.launches["msm_select_reduce"] == 10
