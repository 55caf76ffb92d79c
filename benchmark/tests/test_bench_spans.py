"""The readers of the program's own spans (core/spans.py and the metrics
that use it): a traced tiny verify run on the CPU reports every one of
them, they read made-up records as the port writes them, and each returns
nothing where the program keeps no records.

    python -m pytest benchmark/tests/test_bench_spans.py -q
"""

import json
from types import SimpleNamespace

import pytest
import torch

from benchmark.core import runner, spec
from benchmark.core.runner import Done, RunData
from go_curdleproofs_tpu_torch.utils import profiling

from bench_copy import make_copy

CPU = torch.device("cpu")
SEED = 2 ** 33 + 11
CELL = "tiny4.verify_tiny"
SPAN_METRICS = ("transcript_ms", "recode_ms", "fetch_wait_ms",
                "fetches_per_request", "decode_lane_use", "msm_lane_use")
pytestmark = pytest.mark.xdist_group("spans")


def _copy_reporting_spans(dest):
    """A tiny copy whose verify cell also reports the span metrics."""
    root = make_copy(dest)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"].split(".")[0] in SPAN_METRICS and \
                m["name"].endswith(".verify"):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_a_traced_tiny_verify_reports_every_span_metric(tmp_path):
    root = _copy_reporting_spans(tmp_path)
    cell = spec.load_cell(CELL, root=root)
    assert {m["name"] for m in cell.per_layer} >= {
        f"{n}.verify" for n in SPAN_METRICS}
    drv = runner.prepare(cell, SEED, device=CPU, workers=2)
    profiling.reset()
    result, _ = runner.measure(cell, drv, 0.01, True, device=CPU,
                               setup_s=1.0)
    assert result["correct"], result["checks"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    for name in SPAN_METRICS:
        assert metrics.get(f"{name}.verify") is not None, name
    # counts of fixed work: the decode's two fetches and the final MSM's
    # one; every distinct tracker blob and proof point of the one profiled
    # request (the window's last), as the driver reckons them, in lanes
    # padded to a power of two
    assert metrics["fetches_per_request.verify"] == 3
    points = drv.request(result["attempted"] - 1).work["decode"]
    lanes = 8
    while lanes < points:
        lanes *= 2
    assert metrics["decode_lane_use.verify"] == pytest.approx(
        100 * points / lanes)
    assert 0 < metrics["msm_lane_use.verify"] < 100
    for name in ("transcript_ms", "recode_ms", "fetch_wait_ms"):
        assert metrics[f"{name}.verify"] > 0
    profiling.reset()


def _rec(name, id_, parent, request, start, end, counts=None):
    return SimpleNamespace(name=name, id=id_, parent=parent,
                           request=request, start=start, end=end,
                           counts=counts)


# request 1 inside the first profiled request, request 2 inside the
# second, request 3 (a warm-up, say) inside neither
RECORDS = [
    _rec("root", 1, 0, 1, 1_100_000_000, 1_900_000_000),
    _rec("transcript", 2, 1, 1, 1_200_000_000, 1_300_000_000),
    _rec("fetch", 3, 1, 1, 1_400_000_000, 1_500_000_000),
    _rec("decode", 4, 1, 1, 1_500_000_000, 1_800_000_000,
         {"decode.points": 5, "decode.lanes": 8}),
    _rec("fetch", 5, 4, 1, 1_600_000_000, 1_700_000_000),
    _rec("root", 6, 0, 2, 2_100_000_000, 2_900_000_000),
    _rec("transcript", 7, 6, 2, 2_200_000_000, 2_600_000_000),
    _rec("transcript", 8, 7, 2, 2_300_000_000, 2_400_000_000),
    _rec("decode", 9, 6, 2, 2_600_000_000, 2_700_000_000,
         {"decode.points": 7, "decode.lanes": 8}),
    _rec("root", 10, 0, 3, 5_100_000_000, 5_200_000_000),
    _rec("transcript", 11, 10, 3, 5_110_000_000, 5_190_000_000),
]


def _data(traced=True):
    done = [Done(0, 0.5, 0.9, True, None, 1, {}, {}, {}),
            Done(1, 1.0, 2.0, True, None, 1, {}, {}, {}, profiled=True),
            Done(2, 2.0, 3.0, True, None, 1, {}, {}, {}, profiled=True)]
    return RunData(done, 3.0, 1.0, traced)


def _read(name, data):
    return spec.metric_reader(spec.BENCH_DIR, name).read(data)


def test_the_readers_on_made_up_records(monkeypatch):
    monkeypatch.setattr(profiling, "records", lambda: list(RECORDS))
    d = _data()
    # transcript self time: 100 ms in the first request, 400 - 100 + 100
    # in the second; the third request's is outside every profiled one
    assert _read("transcript_ms.verify", d) == pytest.approx(250.0)
    # fetches: two in the first request, none in the second
    assert _read("fetches_per_request.verify", d) == 1.0
    assert _read("fetch_wait_ms.verify", d) == pytest.approx(100.0)
    assert _read("decode_lane_use.verify", d) == pytest.approx(75.0)
    # no span or counter of that name: nothing to read
    assert _read("recode_ms.verify", d) is None
    assert _read("msm_lane_use.verify", d) is None
    assert _read("transcript_ms.verify", _data(traced=False)) is None


def test_a_profiled_request_without_a_root_reads_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "records", lambda: list(RECORDS[:5]))
    for name in SPAN_METRICS:
        assert _read(f"{name}.verify", _data()) is None


def test_a_program_without_records_reads_nothing(monkeypatch):
    """As at a commit of the program from before its spans: the readers
    return None and raise nothing."""
    monkeypatch.delattr(profiling, "records")
    for name in SPAN_METRICS:
        assert _read(f"{name}.verify", _data()) is None
