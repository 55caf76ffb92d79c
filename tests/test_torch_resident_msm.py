"""The verifier's final MSM reads the decoded points where the decode left
them: the LazyPoints of a DecodePool reach `curve.msm_with_static` /
`curve.msm` as rows of the pool's device points (`DecodePool.pts`), and
only the host-formed bases are converted and uploaded.

On the CPU (the plain versions give the same tensors as the kernels): the
final MSM of a Whisk verify, read from the pool, is the point of the route
that resolves every base to a host Affine and uploads it, byte for byte,
and the host oracle's, at ell=4 (tests/test_torch_parallel_batch.json)
and ell=12 (the golden Whisk vector), for an honest proof and a wrongly
paired one (rejected by the final MSM alone); the counters `msm.resident`
and `msm.uploaded` count the two kinds of base; a point that is both a
LazyPoint and a host Affine, duplicate blobs and the infinity encoding in
the pool; a batch of three through `verify_shuffle_proofs_batch` with no
group. The ell=4 verdicts are held against the JAX package's (imported
inside that test: the module imports nothing of JAX).

On a CUDA card (`-m cuda`; on the card's host: `python -m pytest
--noconftest -o addopts= -m cuda tests/test_torch_resident_msm.py`): a
traced ELL=124 verify whose final MSM reads every decoded point from the
card (`msm.resident`, the LazyPoint bases) and uploads only the
host-formed bases (`msm.uploaded`), with the resolved route's point and
verdict for an honest and a wrongly paired proof.
"""

import json
import random
from pathlib import Path

import pytest
import torch

from go_curdleproofs_tpu_torch.models import curdleproof, whisk
from go_curdleproofs_tpu_torch.models.msm_accumulator import (
    MsmAccumulator, StaticBases)
from go_curdleproofs_tpu_torch.ops import curve
from go_curdleproofs_tpu_torch.parallel import batch
from go_curdleproofs_tpu_torch.utils import codec
from go_curdleproofs_tpu_torch.utils import field_host as fh
from go_curdleproofs_tpu_torch.utils import profiling
from go_curdleproofs_tpu_torch.utils.rand import Rand

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
VERIFY_SEED = 7


def _trackers(pairs):
    return [whisk.WhiskTracker(bytes.fromhex(a), bytes.fromhex(b))
            for a, b in pairs]


def _ell4():
    """(crs, [(pre, post, proof)]): three ell=4 instances of the port's
    host prover."""
    fx = json.loads((ROOT / "tests" / "test_torch_parallel_batch.json")
                    .read_text())
    crs = curdleproof.generate_crs(fx["ell"], Rand(fx["crs_seed"]),
                                   device=CPU)
    return crs, [(_trackers(i["pre"]), _trackers(i["post"]),
                  bytes.fromhex(i["proof"])) for i in fx["instances"]]


def _ell12():
    """(crs, [(pre, post, proof)]): the golden ell=12 Whisk proof."""
    w = json.loads((ROOT / "tests" / "golden_vectors.json").read_text())[
        "whisk"]
    crs = curdleproof.generate_crs(w["ell"], Rand(w["crs_seed"]), device=CPU)
    r = Rand(w["tracker_seed"])
    pre = []
    for _ in range(w["ell"]):
        rr, kk = r.get_fr(), r.get_fr()
        pre.append(whisk.WhiskTracker.from_points(
            fh.g1_mul(fh.G1_GEN, rr), fh.g1_mul(fh.G1_GEN, rr * kk % fh.R)))
    ph = bytes.fromhex(w["post_trackers_hex"])
    post = [whisk.WhiskTracker(ph[96 * i:96 * i + 48],
                               ph[96 * i + 48:96 * i + 96])
            for i in range(w["ell"])]
    return crs, [(pre, post, bytes.fromhex(w["proof_hex"]))]


def _case(crs, insts, case):
    """(pre, post, proof, verdict): the first instance as proved, or its
    proof and pre-trackers with post-trackers that are not its own (the
    next instance's, or its own rotated by one): well formed, and rejected
    by the final MSM alone."""
    pre, post, proof = insts[0]
    if case == "honest":
        return pre, post, proof, True
    other = insts[1][1] if len(insts) > 1 else post[1:] + post[:1]
    return pre, other, proof, False


def _accumulate(crs, pre, post, proof, device):
    """A Whisk verify up to its final MSM (as `verify_shuffle_proofs_batch`
    runs it): its pool, and the accumulator that holds the final MSM."""
    pool = codec.DecodePool(device)
    wp = whisk.WhiskShuffleProof.from_bytes(proof, pool)
    Rs, Ss, Ts, Us = whisk._pool_tracker_sets(pre, post, pool)
    acc = MsmAccumulator(device=device,
                         static_bases=curdleproof._gh_static(crs, device))
    # every check before the final MSM passes, for the wrong pairing too
    assert curdleproof.verify(wp.proof, crs, Rs, Ss, Ts, Us, wp.m,
                              Rand(VERIFY_SEED), device=device,
                              accumulator=acc)
    return acc, pool


def _resolved_total(acc):
    """The final MSM with every dynamic base resolved to a host Affine and
    uploaded: the route before the pool's points stayed on the device."""
    st = acc._static
    static_sc = [0] * (st.sv.width if st else 0)
    dyn_b, dyn_s = [], []
    for b, s in acc._base_scalar.items():
        lane = st.index.get(b) if (st and isinstance(b, tuple)) else None
        if lane is None:
            dyn_b.append(codec.resolve_point(b))
            dyn_s.append(s)
        else:
            static_sc[lane] += s
    if st and any(static_sc):
        return curve.msm_with_static(st.sv, static_sc, dyn_b, dyn_s)
    return curve.msm(dyn_b, dyn_s, device=acc.device)


def _oracle(acc):
    bases = list(acc._base_scalar)
    return fh.g1_msm([codec.resolve_point(b) for b in bases],
                     [acc._base_scalar[b] % fh.R for b in bases])


def _kinds(acc):
    """(LazyPoint bases, host Affine bases off the static row)."""
    st = acc._static
    lazy = sum(isinstance(b, codec.LazyPoint) for b in acc._base_scalar)
    host = sum(isinstance(b, tuple) and not (st and b in st.index)
               for b in acc._base_scalar)
    return lazy, host


def _traced(fn):
    """fn() with the spans on: (its result, the counters summed)."""
    profiling.reset()
    profiling.enable()
    try:
        out = fn()
        recs = profiling.records()
    finally:
        profiling.disable()
        profiling.reset()
    counts = {}
    for r in recs:
        for k, v in (r.counts or {}).items():
            counts[k] = counts.get(k, 0) + v
    return out, counts


SIZES = {"ell4": _ell4, "ell12": _ell12}


@pytest.mark.parametrize("case", ["honest", "wrong_pairing"])
@pytest.mark.parametrize("size", list(SIZES))
def test_resident_route_equals_the_resolved_route(size, case):
    """The final MSM read from the pool is the resolved route's point and
    the oracle's, byte for byte; its verdict is the Whisk verify's; every
    LazyPoint base is read from the pool and only the host-formed bases
    are uploaded."""
    crs, insts = SIZES[size]()
    pre, post, proof, verdict = _case(crs, insts, case)
    acc, pool = _accumulate(crs, pre, post, proof, CPU)
    total, counts = _traced(acc.total)
    want = _resolved_total(acc)
    assert codec.g1_to_bytes(total) == codec.g1_to_bytes(want) \
        == codec.g1_to_bytes(_oracle(acc))
    assert (total is None) == verdict == whisk.is_valid_whisk_shuffle_proof(
        crs, pre, post, proof, Rand(VERIFY_SEED), device=CPU)
    lazy, host = _kinds(acc)
    assert counts["msm.resident"] == lazy > 4 * len(pre)
    assert counts["msm.uploaded"] == host > 0
    # the pool's points: every blob but infinity, (x : y : 1)
    assert tuple(pool.pts.shape) == (3, len(pool._blobs), 12)
    assert curve.to_affine_host(curve.PointVec(*pool.pts)) == [
        pool.get(b) for b in pool._blobs]


def test_ell4_verdicts_match_the_jax_package():
    """The honest proof and the wrong pairing: the port's verdicts (the
    final MSM read from the pool) are the JAX package's."""
    from go_curdleproofs_tpu.models import curdleproof as jcurdleproof
    from go_curdleproofs_tpu.models import whisk as jwhisk
    from go_curdleproofs_tpu.utils.rand import Rand as JRand
    from go_curdleproofs_tpu_torch import convert

    crs, insts = _ell4()
    jcrs = jcurdleproof.CRS(**convert.crs_to_affine(crs))
    got, want = [], []
    for case in ("honest", "wrong_pairing"):
        pre, post, proof, verdict = _case(crs, insts, case)
        got.append(whisk.is_valid_whisk_shuffle_proof(
            crs, pre, post, proof, Rand(VERIFY_SEED), device=CPU))
        jt = lambda ts: [jwhisk.WhiskTracker(t.r_g, t.k_r_g) for t in ts]
        want.append(jwhisk.is_valid_whisk_shuffle_proof(
            jcrs, jt(pre), jt(post), proof, JRand(VERIFY_SEED)))
    assert got == want == [True, False]


def _points(n, seed):
    rng = random.Random(seed)
    return [fh.g1_mul(fh.G1_GEN, rng.randrange(1, fh.R)) for _ in range(n)]


@pytest.mark.parametrize("static", [False, True])
def test_a_point_both_lazy_and_affine(static):
    """A point that is a pool's LazyPoint and also a host Affine takes two
    entries, one read from the pool and one uploaded; their terms sum to
    the oracle's total, with and without a static row."""
    p = _points(4, 3)
    pool = codec.DecodePool(CPU)
    lazy = [pool.add(codec.g1_to_bytes(q)) for q in p[:3]]
    st = None
    if static:
        sv = curve.StackedVec.from_affine([p[2:4]], device=CPU)
        st = StaticBases(sv, p[2:4])
    acc = MsmAccumulator(device=CPU, static_bases=st)
    rng = random.Random(5)
    x = [rng.randrange(fh.R) for _ in range(6)]
    v = [lazy[0], p[0], lazy[1], p[1], lazy[2], p[3]]
    c = fh.g1_msm(v[1:2] * 2 + [p[1]] * 2 + [p[2], p[3]], x)
    acc.accumulate_check(c, x, v, Rand(1))
    total, counts = _traced(acc.total)
    assert total is None and acc.verify()
    assert counts["msm.resident"] == 3
    # p[0], p[1] and c; with the static row, p[3] rides its table
    assert counts["msm.uploaded"] == 3 + (not static)
    bad = MsmAccumulator(device=CPU, static_bases=st)
    bad.accumulate_check(fh.g1_add(c, fh.G1_GEN), x, v, Rand(1))
    assert codec.g1_to_bytes(bad.total()) == codec.g1_to_bytes(
        _resolved_total(bad)) == codec.g1_to_bytes(_oracle(bad))
    assert not bad.verify()


def test_duplicate_blobs_and_infinity_in_the_pool():
    """The infinity encoding takes no row of the pool's points, so the
    rows after it shift; a blob added twice is one key and one row; every
    base is read from its own row."""
    p = _points(3, 7)
    pool = codec.DecodePool(CPU)
    inf = pool.add(codec.g1_to_bytes(None))
    lazy = [pool.add(codec.g1_to_bytes(q)) for q in p]
    again = pool.add(codec.g1_to_bytes(p[1]))
    assert again == lazy[1] and again is not lazy[1]
    assert [pool.row(lp.blob) for lp in [inf] + lazy] == [None, 0, 1, 2]
    assert tuple(pool.pts.shape) == (3, 3, 12)
    acc = MsmAccumulator(device=CPU)
    x = [11, 12, 13, 14, 15]
    acc.accumulate_check([(p[0], 2)], x, [inf, lazy[0], lazy[1], again,
                                          lazy[2]], Rand(2))
    assert len(acc._base_scalar) == 4          # infinity drops; p1 merges
    total, counts = _traced(acc.total)
    assert codec.g1_to_bytes(total) == codec.g1_to_bytes(
        _resolved_total(acc)) == codec.g1_to_bytes(_oracle(acc))
    assert counts["msm.resident"] == 3 and counts["msm.uploaded"] == 1
    ok = MsmAccumulator(device=CPU)
    ok.accumulate_check(fh.g1_msm(p + [p[1]], [12, 13, 14, 15]), x,
                        [inf, lazy[0], lazy[1], lazy[2], again], Rand(3))
    assert ok.verify()


def test_rows_outside_the_resident_points_raise():
    p = _points(2, 9)
    planes = curve.affine_planes(p, device=CPU)
    assert curve.msm([1, p[0]], [3, 4], device=CPU, resident=planes) == \
        fh.g1_msm([p[1], p[0]], [3, 4])
    with pytest.raises(ValueError):
        curve.msm([2, p[0]], [3, 4], device=CPU, resident=planes)
    with pytest.raises(ValueError):
        curve.msm([0], [3], device=CPU)


def test_a_batch_of_three_reads_its_pool(monkeypatch):
    """`verify_shuffle_proofs_batch` with no group: its one final MSM is
    read from the batch's one pool and equals the resolved route's; the
    honest batch is accepted, one with a wrongly paired member rejected."""
    crs, insts = _ell4()
    seen = []
    real = MsmAccumulator.total

    def total(self):
        got = real(self)
        seen.append((got, self))
        return got

    monkeypatch.setattr(MsmAccumulator, "total", total)
    wrong = insts[:2] + [(insts[2][0], insts[0][1], insts[2][2])]
    verdicts = []
    for batch_insts in (insts, wrong):
        ok, counts = _traced(lambda: batch.verify_shuffle_proofs_batch(
            crs, batch_insts, Rand(5), device=CPU))
        verdicts.append(ok)
        got, acc = seen[-1]
        assert codec.g1_to_bytes(got) == codec.g1_to_bytes(
            _resolved_total(acc))
        lazy, host = _kinds(acc)
        assert counts["decode.points"] == counts["msm.resident"] == lazy
        assert counts["msm.uploaded"] == host
    assert verdicts == [True, False]
    assert len(seen) == 2


# -- the card -------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_final_msm_reads_the_pool_on_the_card(cuda_device):
    """A traced ELL=124 verify on the card: the final MSM reads every
    LazyPoint base from the pool's device points (`msm.resident`) and
    uploads only the host-formed bases (`msm.uploaded`); its point and
    verdict are the resolved route's for the honest fixture proof and for
    its proof beside the other instance's post-trackers."""
    fx = json.loads((ROOT / "tests" / "fixture_whisk_ell124.json")
                    .read_text())
    crs = curdleproof.generate_crs(fx["ell"], Rand(fx["crs_seed"]),
                                   device=cuda_device)
    insts = [(_trackers(i["pre"]), _trackers(i["post"]),
              bytes.fromhex(i["proof"])) for i in fx["instances"]]
    for case in ("honest", "wrong_pairing"):
        pre, post, proof, verdict = _case(crs, insts, case)
        acc, pool = _accumulate(crs, pre, post, proof, cuda_device)
        total, counts = _traced(acc.total)
        assert codec.g1_to_bytes(total) == codec.g1_to_bytes(
            _resolved_total(acc))
        assert (total is None) == verdict
        lazy, host = _kinds(acc)
        assert counts["msm.resident"] == lazy == pool.pts.shape[1] > 496
        assert 0 < counts["msm.uploaded"] == host < 16
        ok, counts = _traced(lambda: whisk.is_valid_whisk_shuffle_proof(
            crs, pre, post, proof, Rand(VERIFY_SEED), device=cuda_device))
        assert ok == verdict
        assert counts["msm.resident"] == counts["decode.points"] == lazy
        assert counts["msm.uploaded"] == host
