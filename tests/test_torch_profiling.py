"""The port's tracer (utils/profiling.py): the span tree with request ids
and counters, nothing recorded while it is off, spans that turn on under
torch.profiler and add nothing to its trace, the clock shared with that
trace, the spans of a whole Whisk verification, and the spans at the
curve call sites."""

import ast
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from go_curdleproofs_tpu_torch.models import curdleproof, whisk
from go_curdleproofs_tpu_torch.ops import codec_batch, curve, kernels
from go_curdleproofs_tpu_torch.utils import field_host as fh
from go_curdleproofs_tpu_torch.utils import profiling
from go_curdleproofs_tpu_torch.utils.rand import Rand

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "go_curdleproofs_tpu_torch"
# three ell=4 Whisk instances of the port's host prover
FIXTURE = ROOT / "tests" / "test_torch_parallel_batch.json"


@pytest.fixture
def spans():
    profiling.reset()
    profiling.enable()
    yield profiling
    profiling.disable()
    profiling.reset()


def test_span_accounting(spans):
    for _ in range(3):
        with spans.span("outer"):
            with spans.span("inner"):
                time.sleep(0.002)
    with pytest.raises(KeyError):
        with spans.span("raises"):
            raise KeyError("x")
    got = spans.totals()
    assert {name: calls for name, (_, calls) in got.items()} == {
        "outer": 3, "inner": 3, "raises": 1}
    assert got["outer"][0] >= got["inner"][0] >= 0.006
    lines = spans.report().splitlines()
    assert lines[0].split() == ["span", "calls", "self_ms", "total_ms"]
    # by self time: inner holds the sleeps, outer only its own bookkeeping
    assert [ln.split()[0] for ln in lines[1:3]] == ["inner", "outer"]
    assert lines[1].split()[1] == "3"
    assert float(lines[1].split()[2]) >= 6.0 > float(lines[2].split()[2])
    spans.reset()
    assert spans.totals() == {} and len(spans.report().splitlines()) == 1


def test_spans_off_record_nothing(monkeypatch):
    profiling.disable()
    profiling.reset()
    with profiling.span("off"):
        pass
    # the environment is read once, at import: setting it later does nothing
    monkeypatch.setenv("CURDLE_PROFILE", "1")
    with profiling.span("off"):
        pass
    assert profiling.totals() == {} and profiling.records() == []
    assert not profiling.recording()
    profiling.enable()
    profiling.disable()
    with profiling.span("off"):
        profiling.count("n", 1)
    assert profiling.totals() == {}


def test_the_environment_turns_spans_on_at_import():
    code = ("from go_curdleproofs_tpu_torch.utils import profiling as p\n"
            "with p.span('a'):\n    pass\n"
            "print(p.recording(), [r.name for r in p.records()])\n")
    out = {}
    for value in ("1", "0"):
        res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=300,
                             env=dict(os.environ, PYTHONPATH=str(ROOT),
                                      CURDLE_PROFILE=value))
        assert res.returncode == 0, res.stderr
        out[value] = res.stdout.strip()
    assert out == {"1": "True ['a']", "0": "False []"}


def test_span_tree_ids_parents_requests_and_counts(spans):
    with spans.span("root"):
        spans.count("items", 2)
        with spans.span("child"):
            time.sleep(0.002)
            with spans.span("leaf"):
                spans.count("items", 3)
                spans.count("items", 4)
                spans.count("lanes", 8)
        with spans.span("child"):
            pass
        spans.count("items", 1)
    with spans.span("root"):
        pass
    recs = spans.records()
    assert [r.name for r in recs] == ["root", "child", "leaf", "child",
                                      "root"]
    root, child, leaf, child2, root2 = recs
    assert len({r.id for r in recs}) == 5
    assert (root.parent, child.parent, leaf.parent, child2.parent,
            root2.parent) == (0, root.id, child.id, root.id, 0)
    # one request id a root, shared by every span inside it
    assert {r.request for r in recs[:4]} == {root.request}
    assert root2.request != root.request
    assert root.offset == leaf.offset and root2.offset != 0
    # counters sit on the innermost open span
    assert root.counts == {"items": 3} and child.counts is None
    assert leaf.counts == {"items": 7, "lanes": 8}
    for r in recs:
        assert r.start <= r.end
    own = spans.self_ns(recs)
    assert own[root.id] == root.ns - child.ns - child2.ns
    assert own[child.id] == child.ns - leaf.ns >= 2_000_000
    assert own[leaf.id] == leaf.ns


def test_the_log_is_bounded_and_drains(spans, monkeypatch):
    monkeypatch.setattr(profiling, "LIMIT", 3)
    for _ in range(5):
        with spans.span("s"):
            pass
    assert len(spans.records()) == 3 and spans.dropped() == 2
    assert "2 records dropped" in spans.report()
    assert [r.name for r in spans.drain()] == ["s"] * 3
    assert spans.records() == [] and spans.dropped() == 2
    spans.reset()
    assert spans.dropped() == 0


def _event_names(prof):
    return sorted(e.name for e in prof.events())


def test_spans_record_under_the_profiler_and_add_no_event():
    """No enable(): torch.profiler alone turns the spans on, for as long as
    it records, and its trace holds the same events with or without
    them (a span opens no profiler range)."""
    profiling.disable()
    profiling.reset()
    acts = [torch.profiler.ProfilerActivity.CPU]
    x = torch.ones(64, dtype=torch.int32)
    with torch.profiler.profile(activities=acts) as bare:
        x.cumsum(0)
    with torch.profiler.profile(activities=acts) as spanned:
        with profiling.span("outer"):
            with profiling.span("inner"):
                x.cumsum(0)
    with profiling.span("after"):
        pass
    assert [r.name for r in profiling.records()] == ["outer", "inner"]
    assert _event_names(spanned) == _event_names(bare)
    assert "aten::cumsum" in _event_names(spanned)
    profiling.reset()


def test_spans_share_the_profilers_clock():
    """A profiler range opened 3 ms into a span and closed 3 ms before its
    end lies there on the profiler's axis, once the span's times are
    mapped through its root's clock pair. Slack: 0.5 ms, against a mapped
    position that is off by the offset of two clocks that both read the
    epoch (on torch's CPU build a profiler range starts ~0.25 ms after it
    is asked for)."""
    slack_us = 500.0
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("outer") as rec:
            time.sleep(0.003)
            with torch.profiler.record_function("inside"):
                time.sleep(0.001)
            time.sleep(0.003)
    trace_start = prof.profiler.kineto_results.trace_start_ns()
    ev = next(e for e in prof.events() if e.name == "inside")
    lo = profiling.profiler_us(rec, rec.start, trace_start)
    hi = profiling.profiler_us(rec, rec.end, trace_start)
    assert lo - slack_us <= ev.time_range.start < ev.time_range.end \
        <= hi + slack_us
    assert ev.time_range.start - lo >= 3000 - slack_us
    assert hi - ev.time_range.end >= 3000 - slack_us
    profiling.reset()


def _fixture_instance():
    fx = json.loads(FIXTURE.read_text())
    crs = curdleproof.generate_crs(fx["ell"], Rand(fx["crs_seed"]),
                                   device=CPU)
    inst = fx["instances"][0]
    tr = lambda pairs: [whisk.WhiskTracker(bytes.fromhex(a), bytes.fromhex(b))
                        for a, b in pairs]
    return (fx["ell"], crs, tr(inst["pre"]), tr(inst["post"]),
            bytes.fromhex(inst["proof"]))


def _proof_points(ell: int) -> int:
    """Compressed points in a shuffle proof of ell trackers: M, A, T and U
    (two each), R, S, the same-permutation B, the grand product's C, the
    IPA's B_c, B_d and 4 slices of log2(n), the same-scalar A and B (two
    each), the same-multiscalar B_a, B_t, B_u and 6 slices of log2(n)."""
    rounds = (ell + curdleproof.N_BLINDERS).bit_length() - 1
    return 1 + 1 + 2 + 2 + 1 + 1 + 1 + 1 + 2 + 4 * rounds + 4 + 3 + 6 * rounds


def test_a_whisk_verify_is_one_request_with_its_layers(spans, monkeypatch):
    ell, crs, pre, post, proof = _fixture_instance()
    spans.reset()                       # the CRS's own spans
    seen = {}
    decompress, with_static = (codec_batch.batch_decompress,
                               curve.msm_with_static)

    def decoding(blobs, **kw):
        seen["blobs"] = list(blobs)
        return decompress(blobs, **kw)

    def final(sv, st, points, scalars, **kw):
        seen["msm"] = (sv.width, list(st), list(points), list(scalars))
        return with_static(sv, st, points, scalars, **kw)

    monkeypatch.setattr(codec_batch, "batch_decompress", decoding)
    monkeypatch.setattr(curve, "msm_with_static", final)
    assert whisk.is_valid_whisk_shuffle_proof(crs, pre, post, proof,
                                              Rand(5), device=CPU)
    recs = spans.records()
    roots = [r for r in recs if r.parent == 0]
    assert [r.name for r in roots] == ["whisk.is_valid_whisk_shuffle_proof"]
    assert {r.request for r in recs} == {roots[0].request}
    names = {r.name for r in recs}
    assert {"transcript", "decode", "msm", "recode", "fetch", "upload",
            "convert", "curdleproof.verify", "same_permutation.verify",
            "grand_product.verify", "inner_product.verify",
            "same_scalar.verify", "same_multiscalar.verify", "accumulate",
            "final_msm", "deserialize", "parse"} <= names
    # the decode's one fetch (y and flags together) and the final MSM's one
    assert sum(r.name == "fetch" for r in recs) == 2
    decode = next(r for r in recs if r.name == "decode")
    assert sorted(r.name for r in recs if r.parent == decode.id) == [
        "fetch", "parse", "upload"]
    counts = {}
    for r in recs:
        for k, v in (r.counts or {}).items():
            counts[k] = counts.get(k, 0) + v
    # every tracker blob (distinct) and every proof point, one slot each,
    # in whole blocks of the decode kernel
    trackers = {b for t in pre + post for b in (t.r_g, t.k_r_g)}
    points = len(trackers) + _proof_points(ell)
    assert len(seen["blobs"]) == points
    assert counts["decode.points"] == points
    assert counts["decode.lanes"] == kernels.decode_slots(points)
    assert counts["decode.lanes"] - points < kernels.DECODE_BLOCK_POINTS
    width, static, dyn_points, dyn_scalars = seen["msm"]
    assert counts["msm.lanes"] == width + curve._pad_pow2(len(dyn_points))
    assert counts["msm.terms"] == sum(s % fh.R != 0
                                      for s in static + dyn_scalars)
    assert 0 < counts["msm.terms"] <= counts["msm.lanes"]
    # the decoded points reach the final MSM as rows of the pool's device
    # points; only the host-formed bases are uploaded
    rows = [p for p in dyn_points if isinstance(p, int)]
    assert counts["msm.resident"] == len(rows) == len(set(rows)) > 0
    assert counts["msm.uploaded"] == len(dyn_points) - len(rows) > 0


def test_spans_at_the_curve_call_sites(spans):
    rng = np.random.default_rng(3)
    pts = [fh.g1_mul(fh.G1_GEN, int(rng.integers(1, 1 << 62)))
           for _ in range(6)]
    assert curve.batch_scalar_mul(pts, [5] * 6, device=CPU) == [
        fh.g1_mul(p, 5) for p in pts]
    sv = curve.StackedVec.from_affine([pts, pts[::-1]], device=CPU)
    sv.msm_many([[(0, [1, 2], 0)], [(1, [3], 1)]])
    sv.fold([2, 3])
    got = {name: calls for name, (_, calls) in spans.totals().items()}
    # batch_scalar_mul: msm (upload, recode, upload, fetch, convert); the
    # bases: upload; msm_many: msm (recode, upload, fetch, convert twice);
    # the fold: fold (recode, upload)
    assert got == {"msm": 2, "upload": 5, "recode": 3, "fetch": 2,
                   "convert": 3, "fold": 1}
    counts = {}
    for r in spans.records():
        if r.counts:
            assert r.name in ("msm", "recode")
            for k, v in r.counts.items():
                counts[r.name, k] = counts.get((r.name, k), 0) + v
    # 6 of 8 lanes, then two rows of width 8 holding 2 and 1 scalars; the
    # scalars recoded, pad lanes and the fold's two gammas included, none
    # of them on a card
    assert counts == {("msm", "msm.lanes"): 8 + 16,
                      ("msm", "msm.terms"): 6 + 3,
                      ("recode", "recode.scalars"): 8 + 16 + 2,
                      ("recode", "recode.on_card"): 0}


def _span_names(tree):
    """(name node, line) of every span(...) / traced(...) call."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and node.args
                and getattr(node.func, "attr",
                            getattr(node.func, "id", None))
                in ("span", "traced")):
            yield node.args[0], node.lineno


def test_span_names_are_static_and_the_tracer_stays_off_the_profiler():
    """Every span name in the port is a string constant (no f-string is
    formatted on the off path), none begins with the benchmark's `bench.`
    prefix; the tracer opens no profiler range and reads the environment
    only at import."""
    found = 0
    for path in sorted(PORT.rglob("*.py")):
        for arg, line in _span_names(ast.parse(path.read_text())):
            where = f"{path.relative_to(ROOT)}:{line}"
            assert isinstance(arg, ast.Constant) and isinstance(
                arg.value, str), f"{where}: a span name is not a constant"
            assert not arg.value.startswith("bench."), where
            assert re.fullmatch(r"[a-z0-9_.]+", arg.value), where
            found += 1
    assert found > 30
    src = (PORT / "utils" / "profiling.py").read_text()
    assert "record_function" not in src and "synchronize" not in src
    tree = ast.parse(src)
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            assert "environ" not in ast.unparse(node), node.name
