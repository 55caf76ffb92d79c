"""The GLV recode of the host MSMs' scalars (`kernels.glv_recode`, its plain
version `kernels.glv_recode_plain`, and `curve.recode` around them).

On the CPU: the plain version word for word against the host's
`glv.scalars_to_digits_glv` at the Barrett corrections' edges and on
seeded random scalars; zero words give zero rows; the wrapper's checks;
`curve.recode`'s byte layout (scalars mod r at their offsets, pad lanes
zero, rows one after the other); each host MSM entry point recodes its
scalars in one `glv_recode` call, `msm_many`'s rows reshaped to the
per-row host digits; and the counters `recode.scalars`, `recode.on_card`,
`msm.lanes` and `msm.terms` on a traced MSM.

On a CUDA card (`-m cuda`; this file imports nothing of JAX, so on the
card's host: `python -m pytest --noconftest -o addopts= -m cuda
tests/test_torch_glv_recode.py`): the kernel word for word against the
host at the edges, on 10,000 seeded random scalars and on a padded batch,
and `recode.on_card` equal to `recode.scalars` on a traced ELL=124
verify.
"""

import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from go_curdleproofs_tpu_torch.ops import curve, glv, kernels
from go_curdleproofs_tpu_torch.utils import field_host as fh
from go_curdleproofs_tpu_torch.utils import profiling

CPU = torch.device("cpu")
W = glv.NUM_WINDOWS
L = glv.LAMBDA
ROOT = Path(__file__).resolve().parents[1]

# the quotient's and the remainder's edges: Barrett's estimate falls short
# of the quotient by up to 2 just below a multiple of lambda
EDGES = {"0": 0, "1": 1, "lambda-1": L - 1, "lambda": L, "lambda+1": L + 1,
         "2lambda-1": 2 * L - 1, "2lambda": 2 * L, "3lambda-1": 3 * L - 1,
         "3lambda": 3 * L, "2^128-1": (1 << 128) - 1, "2^128": 1 << 128,
         "r-1": fh.R - 1, "r-lambda": fh.R - L}


def _words(scalars, device=CPU) -> torch.Tensor:
    """Canonical scalars -> [m, 8] int32 little-endian words."""
    buf = bytearray().join(s.to_bytes(32, "little") for s in scalars)
    return torch.from_numpy(
        np.frombuffer(buf, np.int32).reshape(-1, 8)).to(device)


def _random(seed: int, n: int):
    rng = random.Random(seed)
    return [rng.randrange(fh.R) for _ in range(n)]


@pytest.mark.parametrize("name", list(EDGES))
def test_plain_recode_equals_host_at_the_edges(name):
    s = EDGES[name]
    got = kernels.glv_recode_plain(_words([s]))
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, W)
    assert np.array_equal(got.numpy(), glv.scalars_to_digits_glv([s]))
    # s = s1 + lambda s2 from the rows, MSB window first
    s1, s2 = (sum(int(d) * 16 ** (W - 1 - k) for k, d in enumerate(row))
              for row in got.tolist())
    assert s1 + L * s2 == s and 0 <= s1 < L


@pytest.mark.parametrize("seed", [23, 2 ** 33 + 5])
def test_plain_recode_equals_host_on_random_scalars(seed):
    sc = _random(seed, 300) + list(EDGES.values())
    # neighbours of multiples of lambda across the whole range
    rng = random.Random(seed + 1)
    sc += [min(fh.R - 1, rng.randrange(L + 2) * L + d)
           for d in (-2, -1, 0, 1) for _ in range(50)]
    sc = [max(s, 0) for s in sc]
    assert len(sc) >= 500
    got = kernels.glv_recode(_words(sc))
    assert np.array_equal(got.numpy(), glv.scalars_to_digits_glv(sc))


def test_zero_words_give_zero_rows():
    sc = _random(5, 3)
    words = torch.cat([_words(sc), torch.zeros((5, 8), dtype=torch.int32)])
    got = kernels.glv_recode(words)
    assert tuple(got.shape) == (16, W)
    assert not got[6:].any()
    assert np.array_equal(got[:6].numpy(), glv.scalars_to_digits_glv(sc))
    assert tuple(kernels.glv_recode(
        torch.zeros((0, 8), dtype=torch.int32)).shape) == (0, W)


def test_glv_recode_checks_its_input():
    with pytest.raises(ValueError):
        kernels.glv_recode(torch.zeros((4, 12), dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.glv_recode(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(TypeError):
        kernels.glv_recode(torch.zeros((4, 8), dtype=torch.int64))
    with pytest.raises(ValueError):
        kernels.glv_recode(torch.zeros((8, 4), dtype=torch.int32).t())


def test_recode_lays_out_rows_of_scalars_mod_r(monkeypatch):
    """Scalars of any sign or size at their offsets, zero lanes around
    them, rows one after the other (numpy integers too); one glv_recode
    call."""
    sc = [-1, fh.R, 3 * fh.R + 5, 7, 2 ** 300]
    rows = [(sc, 2, 8), ([1, 2], 0, 3), ([], 0, 2),
            (list(np.array([-9, 4], np.int64)), 1, 3)]
    calls = []
    real = kernels.glv_recode
    monkeypatch.setattr(kernels, "glv_recode",
                        lambda w: calls.append(tuple(w.shape)) or real(w))
    got = curve.recode(rows, CPU)
    assert calls == [(16, 8)]
    want = glv.scalars_to_digits_glv(
        [0, 0] + [s % fh.R for s in sc] + [0] + [1, 2, 0] + [0, 0]
        + [0, fh.R - 9, 4])
    assert np.array_equal(got.numpy(), want)
    assert not hasattr(curve, "scalars_to_digits")


def _points(n: int, seed: int):
    rng = random.Random(seed)
    return [fh.g1_mul(fh.G1_GEN, rng.randrange(1, fh.R)) for _ in range(n)]


def test_each_host_entry_point_is_one_recode_launch(monkeypatch):
    calls = []
    real = kernels.glv_recode
    monkeypatch.setattr(kernels, "glv_recode",
                        lambda w: calls.append(w.shape[0]) or real(w))
    pts = _points(6, 3)
    sc = [5, 0, fh.R - 1, 11, -3, 2 ** 256]
    mod = [s % fh.R for s in sc]

    def once(what, got, want, lanes):
        assert got == want, what
        assert calls == [lanes], (what, calls)
        calls.clear()

    once("batch_scalar_mul", curve.batch_scalar_mul(pts, sc, device=CPU),
         [fh.g1_mul(p, s) for p, s in zip(pts, mod)], 8)
    once("msm", curve.msm(pts, sc, device=CPU), fh.g1_msm(pts, mod), 8)
    sv = curve.StackedVec.from_affine([pts[:4], pts[2:]], device=CPU)
    once("msm_with_static", curve.msm_with_static(sv, sc[:3], pts[3:],
                                                  sc[3:]),
         fh.g1_add(fh.g1_msm(pts[:3], mod[:3]),
                   fh.g1_msm(pts[3:], mod[3:])), 8 + 8)
    once("msm_many", sv.msm_many([[(0, sc[:2], 1)], [(1, sc[2:4], 0),
                                                     (0, sc[4:5], 3)]]),
         [fh.g1_msm(pts[1:3], mod[:2]),
          fh.g1_add(fh.g1_msm(pts[2:4], mod[2:4]),
                    fh.g1_mul(pts[3], mod[4]))], 3 * 8)
    dv = curve.DeviceVec.from_affine(pts, device=CPU)
    once("DeviceVec.msm", dv.msm(sc[:3], offset=2),
         fh.g1_msm(pts[2:5], mod[:3]), 8)
    folded = dv.fold(7)
    assert calls == [1]
    assert folded.to_affine() == [fh.g1_add(pts[i], fh.g1_mul(pts[i + 3], 7))
                                  for i in range(3)]


def test_msm_many_digits_are_the_stacked_row_digits(monkeypatch):
    """The [k, 2w, W] digits that a two-row msm_many hands the wide phase
    equal the host digits of each row, its scalars at their offsets."""
    pts = _points(8, 9)
    sv = curve.StackedVec.from_affine([pts, pts[::-1]], device=CPU)
    seen = []
    real = curve.msm_rows_points_from_table

    def keep(table, digits, rows):
        seen.append((digits.clone(), list(rows)))
        return real(table, digits, rows)

    monkeypatch.setattr(curve, "msm_rows_points_from_table", keep)
    a, b = _random(41, 3), _random(42, 5)
    got = sv.msm_many([[(1, a, 4)], [(0, b, 0)]])
    assert got == [fh.g1_msm(pts[::-1][4:7], a), fh.g1_msm(pts[:5], b)]
    (digits, rows), = seen
    assert rows == [1, 0]
    want = np.stack([glv.scalars_to_digits_glv([0] * 4 + a + [0]),
                     glv.scalars_to_digits_glv(b + [0] * 3)])
    assert tuple(digits.shape) == (2, 16, W)
    assert np.array_equal(digits.numpy(), want)


def test_recode_counts_on_a_traced_msm():
    """msm.lanes and msm.terms count what the host digits gave before
    (base lanes, and bases whose scalar is not zero mod r);
    recode.scalars the lanes recoded, recode.on_card none on the CPU."""
    pts = _points(5, 13)
    sc = [0, 3, fh.R, 2 * fh.R + 1, 9]
    profiling.reset()
    profiling.enable()
    try:
        assert curve.msm(pts, sc, device=CPU) == fh.g1_msm(
            pts, [s % fh.R for s in sc])
        recs = profiling.records()
    finally:
        profiling.disable()
        profiling.reset()
    counts = {}
    for r in recs:
        for k, v in (r.counts or {}).items():
            counts[r.name, k] = counts.get((r.name, k), 0) + v
    assert counts == {("msm", "msm.lanes"): 8, ("msm", "msm.terms"): 3,
                      ("msm", "msm.resident"): 0, ("msm", "msm.uploaded"): 5,
                      ("recode", "recode.scalars"): 8,
                      ("recode", "recode.on_card"): 0}
    # the host's part alone: the words' upload and the launch follow it
    (rec,) = [r for r in recs if r.name == "recode"]
    assert not [r for r in recs if r.parent == rec.id]
    msm = next(r for r in recs if r.name == "msm")
    assert [r.name for r in recs if r.parent == msm.id][:2] == [
        "recode", "upload"]


# -- the card -------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_glv_recode_equals_host(cuda_device):
    """The kernel at the edges, on 10,000 seeded random scalars (more than
    one block, a ragged last one) and on a padded batch, word for word
    against the host and its plain version."""
    sc = list(EDGES.values()) + _random(2 ** 31 + 11, 10_000)
    kernels.reset_launches()
    got = kernels.glv_recode(_words(sc, cuda_device))
    assert kernels.launches["glv_recode"] == 1
    assert np.array_equal(got.cpu().numpy(), glv.scalars_to_digits_glv(sc))
    words = torch.cat([_words(sc[:200], cuda_device),
                       torch.zeros((57, 8), dtype=torch.int32,
                                   device=cuda_device)])
    got = kernels.glv_recode(words)
    assert torch.equal(got, kernels.glv_recode_plain(words))
    assert not got[400:].any()
    for m in (1, 127, 128, 129):
        w = _words(sc[:m], cuda_device)
        assert torch.equal(kernels.glv_recode(w), kernels.glv_recode_plain(w))


@pytest.mark.cuda
def test_cuda_recode_is_on_the_card_in_a_traced_verify(cuda_device):
    """A traced ELL=124 Whisk verify on the card: every scalar it recodes,
    the kernel recodes (recode.on_card == recode.scalars)."""
    from go_curdleproofs_tpu_torch.models import curdleproof, whisk
    from go_curdleproofs_tpu_torch.utils.rand import Rand

    fx = json.loads((ROOT / "tests" / "fixture_whisk_ell124.json").read_text())
    crs = curdleproof.generate_crs(fx["ell"], Rand(fx["crs_seed"]),
                                   device=cuda_device)
    tr = lambda pairs: [whisk.WhiskTracker(bytes.fromhex(a), bytes.fromhex(b))
                        for a, b in pairs]
    inst = fx["instances"][0]
    args = (crs, tr(inst["pre"]), tr(inst["post"]),
            bytes.fromhex(inst["proof"]))
    profiling.reset()
    profiling.enable()
    kernels.reset_launches()
    try:
        assert whisk.is_valid_whisk_shuffle_proof(*args, Rand(7),
                                                  device=cuda_device)
        recs = profiling.records()
    finally:
        profiling.disable()
        profiling.reset()
    total = {}
    for r in recs:
        for k, v in (r.counts or {}).items():
            total[k] = total.get(k, 0) + v
    assert total["recode.scalars"] > 0
    assert total["recode.on_card"] == total["recode.scalars"]
    assert kernels.launches["glv_recode"] == sum(
        r.name == "recode" for r in recs) == 1
