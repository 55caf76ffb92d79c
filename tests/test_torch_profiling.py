"""The port's span layer (utils/profiling.py): per-name accounting while
CURDLE_PROFILE=1 is set, nothing recorded otherwise, the spans at the JAX
package's call sites (ops/curve.py), and the torch.profiler trace that
CURDLE_TORCH_TRACE asks for."""

import json
import time

import numpy as np
import pytest
import torch

from go_curdleproofs_tpu_torch.ops import curve
from go_curdleproofs_tpu_torch.utils import field_host as fh
from go_curdleproofs_tpu_torch.utils import profiling

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture
def spans(monkeypatch):
    monkeypatch.setenv("CURDLE_PROFILE", "1")
    profiling.reset()
    yield profiling
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
    assert lines[0].split() == ["span", "calls", "total_ms", "avg_ms"]
    assert [ln.split()[0] for ln in lines[1:3]] == ["outer", "inner"]
    assert lines[1].split()[1] == "3"
    spans.reset()
    assert spans.totals() == {} and len(spans.report().splitlines()) == 1


def test_spans_off_record_nothing(monkeypatch):
    monkeypatch.delenv("CURDLE_PROFILE", raising=False)
    profiling.reset()
    with profiling.span("off"):
        pass
    monkeypatch.setenv("CURDLE_PROFILE", "0")
    with profiling.span("off"):
        pass
    assert profiling.totals() == {}


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
    assert got == {"batch_scalar_mul[8]": 1, "to_affine_host_xy": 1,
                   "msm_many[2x2x8]": 1, "to_affine_host.fetch": 1,
                   "fold[2x8]": 1}


def test_torch_trace_writes_a_chrome_trace(monkeypatch, tmp_path):
    monkeypatch.setenv("CURDLE_TORCH_TRACE", str(tmp_path / "trace"))
    with profiling.torch_trace():
        torch.ones(64).cumsum(0)
    files = list((tmp_path / "trace").iterdir())
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("cumsum" in str(e.get("name", "")) for e in events)
    monkeypatch.delenv("CURDLE_TORCH_TRACE")
    with profiling.torch_trace():
        pass
    assert len(list((tmp_path / "trace").iterdir())) == 1
