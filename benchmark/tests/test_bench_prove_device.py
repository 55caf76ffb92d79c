"""The cell `whisk124.prove_device` on the CPU: the `prove_chain` driver
with `"prover": "device"` through the harness's own entry (runner.prepare /
measure) at ELL=4 reads correct when sound and not correct under each
plant of controls.py; the readers of the device prover's spans and counter
(`enqueue_ms`, `upload_ms`, `chain_kernels`) read made-up records as the
port writes them and return nothing where the spans are absent, as at a
commit whose device prover has none.

    python -m pytest benchmark/tests/test_bench_prove_device.py -q
"""

import json
from types import SimpleNamespace

import pytest
import torch

from benchmark import controls
from benchmark.core import runner, spec
from benchmark.core.runner import Done, RunData
from go_curdleproofs_tpu_torch.utils import profiling

from bench_copy import make_copy

CPU = torch.device("cpu")
SEED = 2 ** 33 + 13
CELL = "tiny4.prove_tiny_device"
# as traffic/prove_device.json, at ELL=4 and with no profiled prove (the
# CPU profiler's events of one ELL=4 prove take minutes to read back)
MIX = {"kind": "prove_chain", "prover": "device", "warm_requests": 1,
       "trace_requests": 0, "check_requests": 2}
NEW_READERS = ("enqueue_ms", "upload_ms", "chain_kernels")
pytestmark = pytest.mark.xdist_group("prove_device")


def _copy_with_the_device_cell(dest):
    """A tiny copy with an ELL=4 device-prover cell that reports what
    `whisk124.prove_device` reports."""
    root = make_copy(dest)
    (root / "benchmark" / "traffic" / "prove_tiny_device.json").write_text(
        json.dumps(MIX))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "tiny4",
                               "traffic": "prove_tiny_device", "chips": 1,
                               "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "whisk124.prove_device" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    root = _copy_with_the_device_cell(tmp_path_factory.mktemp("bench"))
    cell = spec.load_cell(CELL, root=root)
    return cell, runner.prepare(cell, SEED, device=CPU, workers=2)


def _measure(cell, drv):
    result, _ = runner.measure(cell, drv, 0.01, False, device=CPU,
                               setup_s=1.0)
    return result


def test_the_cell_reports_prove_ms_and_the_new_layers():
    cell = spec.load_cell("whisk124.prove_device")
    assert cell.traffic["prover"] == "device"
    assert cell.traffic["kind"] == "prove_chain"
    assert {m["name"] for m in cell.end_to_end} == {"prove_ms", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert {f"{n}.device_prove" for n in NEW_READERS} <= names
    assert all(m["moves"] == "prove_ms" for m in cell.per_layer)


def test_sound_device_prove_run_is_correct(prepared):
    cell, drv = prepared
    result = _measure(cell, drv)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"prove_ms", "setup_s"}
    assert result["failed"] == 0 and result["attempted"] >= 1


@pytest.mark.parametrize("plant", controls.PLANTS["prove_chain"])
def test_a_planted_fault_in_the_device_prove_is_caught(prepared, plant):
    cell, drv = prepared
    with controls.plant("prove_chain", plant, drv):
        result = _measure(cell, drv)
    assert not result["correct"], result["checks"]


def _rec(name, id_, parent, request, start, end, counts=None):
    return SimpleNamespace(name=name, id=id_, parent=parent,
                           request=request, start=start, end=end,
                           counts=counts)


def _prove_records(request, t0, upload_ms, chain_ms, kernels):
    """One request's records as the port writes them: root, prove,
    device_prove with an upload (holding a nested upload), the chain with
    a piece and its counter, the fetch and assemble; ids from 100 *
    request, times in ns from t0."""
    i, ms = 100 * request, 1_000_000
    up_end = t0 + 10 * ms + upload_ms * ms
    ch_end = up_end + chain_ms * ms
    return [
        _rec("whisk.generate_whisk_shuffle_proof", i, 0, request, t0,
             t0 + 900 * ms),
        _rec("upload", i + 1, i, request, t0 + 1 * ms, t0 + 2 * ms),
        _rec("curdleproof.prove", i + 2, i, request, t0 + 5 * ms,
             t0 + 800 * ms),
        _rec("device_prove", i + 3, i + 2, request, t0 + 6 * ms,
             t0 + 790 * ms),
        _rec("upload", i + 4, i + 3, request, t0 + 10 * ms, up_end),
        _rec("upload", i + 5, i + 4, request, t0 + 11 * ms, t0 + 12 * ms),
        _rec("chain", i + 6, i + 3, request, up_end, ch_end,
             {"chain.kernels": kernels}),
        _rec("ipa", i + 7, i + 6, request, up_end, up_end + ms),
        _rec("fetch", i + 8, i + 3, request, ch_end, ch_end + 5 * ms),
        _rec("assemble", i + 9, i + 3, request, ch_end + 5 * ms,
             ch_end + 6 * ms),
    ]


S = 1_000_000_000
# request 1 inside the first profiled request, 2 inside the second, 3 (a
# warm-up, say) inside neither
RECORDS = (_prove_records(1, 1 * S, 20, 170, 868)
           + _prove_records(2, 3 * S, 30, 150, 870)
           + _prove_records(3, 9 * S, 99, 999, 1))


def _data(traced=True):
    done = [Done(0, 0.5, 0.9, True, None, 1, {}, {}, {}),
            Done(1, 1.0, 2.0, True, None, 1, {}, {}, {}, profiled=True),
            Done(2, 3.0, 4.0, True, None, 1, {}, {}, {}, profiled=True)]
    return RunData(done, 4.0, 1.0, traced)


def _read(name, data):
    return spec.metric_reader(spec.BENCH_DIR, name).read(data)


def test_the_new_readers_on_made_up_records(monkeypatch):
    monkeypatch.setattr(profiling, "records", lambda: list(RECORDS))
    d = _data()
    # the chain spans' wall, not their self time; the upload that is a
    # child of device_prove, with the upload inside it and not the one
    # under the root
    assert _read("enqueue_ms.device_prove", d) == pytest.approx(160.0)
    assert _read("upload_ms.device_prove", d) == pytest.approx(25.0)
    assert _read("chain_kernels.device_prove", d) == pytest.approx(869.0)
    # the existing readers, by stem
    assert _read("fetches_per_request.device_prove", d) == 1.0
    assert _read("fetch_wait_ms.device_prove", d) == pytest.approx(5.0)
    for name in NEW_READERS:
        assert _read(f"{name}.device_prove", _data(traced=False)) is None


def test_the_new_readers_read_nothing_without_the_device_provers_spans(
        monkeypatch):
    """As at a commit whose device prover records none of these spans
    (its prove holds other names): nothing to read, nothing raised."""
    old = [SimpleNamespace(**dict(vars(r), counts=None, name=(
        "dp." + r.name if r.name in ("device_prove", "chain") else r.name)))
        for r in RECORDS]
    monkeypatch.setattr(profiling, "records", lambda: list(old))
    for name in NEW_READERS:
        assert _read(f"{name}.device_prove", _data()) is None


def test_the_new_readers_read_nothing_from_a_program_without_records(
        monkeypatch):
    monkeypatch.delattr(profiling, "records")
    for name in NEW_READERS:
        assert _read(f"{name}.device_prove", _data()) is None
