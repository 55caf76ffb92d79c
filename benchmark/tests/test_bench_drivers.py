"""Each driver through the harness's own entry (runner.prepare / measure),
skipping only the look for a card, on the CPU at ELL=4: a sound run reads
correct, and a run with any plant of controls.py under the timed path
reads not correct.

    python -m pytest benchmark/tests -n 4 --dist loadgroup

(the cases of one kind share a worker and its set-up under loadgroup).
"""

import time

import pytest
import torch

from benchmark import controls
from benchmark.core import runner, spec

CPU = torch.device("cpu")
SEED = 2 ** 33 + 7
CELLS = {"verify_stream": "tiny4.verify_tiny",
         "prove_chain": "tiny4.prove_tiny",
         "sync_batch": "tiny4.sync_tiny"}
KINDS = [pytest.param(k, marks=pytest.mark.xdist_group(k)) for k in sorted(CELLS)]
E2E = {"verify_stream": {"verify_ms", "verify_ms_p95", "setup_s"},
       "prove_chain": {"prove_ms", "setup_s"},
       "sync_batch": {"batch_proofs_per_s", "setup_s"}}


@pytest.fixture(scope="session")
def prepared(tiny_root):
    """kind -> (cell, driver after set-up and warm-up, window seconds).
    A verify window holds two requests, so that one of them is the wrong
    pairing; the others one request."""
    cache = {}

    def get(kind):
        if kind not in cache:
            cell = spec.load_cell(CELLS[kind], root=tiny_root)
            drv = runner.prepare(cell, SEED, device=CPU, workers=2)
            seconds = 0.01
            if kind == "verify_stream":
                t0 = time.perf_counter()
                drv.request(0).run()
                seconds = 1.6 * (time.perf_counter() - t0)
            cache[kind] = cell, drv, seconds
        return cache[kind]
    return get


def _measure(cell, drv, seconds, traced=False):
    result, _ = runner.measure(cell, drv, seconds, traced, device=CPU,
                               setup_s=1.0)
    return result


@pytest.mark.parametrize("kind", KINDS)
def test_sound_run_is_correct(prepared, kind):
    cell, drv, seconds = prepared(kind)
    result = _measure(cell, drv, seconds)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == E2E[kind]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("kind", KINDS)
def test_traced_run_reads_the_sections(prepared, kind):
    """On the CPU the sections read; the device metrics find nothing to
    read and are left out, never 0."""
    cell, drv, _ = prepared(kind)
    metrics = _measure(cell, drv, 0.01, traced=True)["metrics"]
    names = {m.split(".")[0] for m in metrics}
    assert {"host_rest_ms", "decode_ms", "msm_ms"} <= names
    assert not names & {"launches_per_request", "kernel_roofline_share",
                        "device_idle_share"}


@pytest.mark.parametrize("kind,plant", [
    pytest.param(k, p, marks=pytest.mark.xdist_group(k))
    for k in sorted(CELLS) for p in controls.PLANTS[k]])
def test_a_planted_fault_is_caught(prepared, kind, plant):
    cell, drv, seconds = prepared(kind)
    with controls.plant(kind, plant, drv):
        result = _measure(cell, drv, seconds)
    assert not result["correct"], result["checks"]
