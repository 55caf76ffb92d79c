"""The reader `chain_replay_share` (cell `whisk124.prove_device`) on made-up
records as the port writes them: the `chain` spans that counted a replay of
the device prover's CUDA graph (`chain.replays` 1) over all `chain` spans of
the profiled requests, in %; nothing where no `chain` span counts
`chain.replays` (a device prover with no graph), where nothing is traced,
or where the program keeps no records.

    python -m pytest benchmark/tests/test_bench_chain_replay_share.py -q
"""

from types import SimpleNamespace

import pytest

from benchmark.core import spec
from benchmark.core.runner import Done, RunData
from go_curdleproofs_tpu_torch.utils import profiling

NAME = "chain_replay_share.device_prove"
S, MS = 1_000_000_000, 1_000_000


def _rec(name, id_, parent, request, start, end, counts=None):
    return SimpleNamespace(name=name, id=id_, parent=parent,
                           request=request, start=start, end=end,
                           counts=counts)


def _prove(request, t0, replays=None):
    """One request's records: the root, device_prove, the chain with its
    counters (`chain.replays` where `replays` is given), the fetch."""
    i = 100 * request
    counts = {"chain.kernels": 845}
    if replays is not None:
        counts["chain.replays"] = replays
    return [
        _rec("whisk.generate_whisk_shuffle_proof", i, 0, request, t0,
             t0 + 90 * MS),
        _rec("device_prove", i + 1, i, request, t0 + 1 * MS, t0 + 80 * MS),
        _rec("chain", i + 2, i + 1, request, t0 + 20 * MS, t0 + 27 * MS,
             counts),
        _rec("fetch", i + 3, i + 1, request, t0 + 27 * MS, t0 + 75 * MS),
    ]


def _data(traced=True):
    """Requests 2 and 3 profiled (at 1-2 s and 3-4 s), request 1 not."""
    done = [Done(0, 0.5, 0.9, True, None, 1, {}, {}, {}),
            Done(1, 1.0, 2.0, True, None, 1, {}, {}, {}, profiled=True),
            Done(2, 3.0, 4.0, True, None, 1, {}, {}, {}, profiled=True)]
    return RunData(done, 4.0, 1.0, traced)


def _read(data):
    return spec.metric_reader(spec.BENCH_DIR, NAME).read(data)


@pytest.mark.parametrize("replays, share", [
    ((1, 1), 100.0),            # warm: every profiled chain a replay
    ((1, 0), 50.0),
    ((0, 0), 0.0),              # the eager chain counts 0, not nothing
])
def test_the_share_of_replayed_chains(monkeypatch, replays, share):
    recs = (_prove(1, 1 * S, replays[0]) + _prove(2, 3 * S, replays[1])
            + _prove(3, 9 * S, 0))          # outside the profiled requests
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    assert _read(_data()) == pytest.approx(share)
    assert _read(_data(traced=False)) is None


def test_nothing_to_read_without_the_counter(monkeypatch):
    """As at a commit whose device prover has no graph: its chain spans
    count `chain.kernels` alone."""
    recs = _prove(1, 1 * S) + _prove(2, 3 * S)
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    assert _read(_data()) is None


def test_nothing_to_read_from_a_program_without_records(monkeypatch):
    monkeypatch.delattr(profiling, "records")
    assert _read(_data()) is None


def test_the_metric_is_reported_in_the_device_prove_cell_only():
    cell = spec.load_cell("whisk124.prove_device")
    (m,) = [m for m in cell.per_layer if m["name"] == NAME]
    assert (m["unit"], m["better"], m["source"], m["moves"]) == (
        "%", "higher", "program_counter", "prove_ms")
    for other in ("whisk124.prove_chain", "whisk124.verify_stream",
                  "ell508.verify_stream"):
        assert NAME not in {m["name"]
                            for m in spec.load_cell(other).per_layer}
