"""A checkout-like copy of the benchmark with tiny cells (ELL=4) beside
the real ones, for runs of the drivers on the CPU."""

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CONFIG = {"name": "tiny4", "ell": 4, "n": 8,
               "CURDLEPROOFS_N_BLINDERS": 4}
TINY_TRAFFIC = {
    "verify_tiny": {"kind": "verify_stream", "chain": 2, "reject_every": 2,
                    "warm_requests": 1, "trace_requests": 1,
                    "check_accepts": 2, "check_rejects": 1},
    # no profiled prove: the CPU profiler's events of one ELL=4 prove take
    # minutes to read back (the verify and sync mixes profile theirs)
    "prove_tiny": {"kind": "prove_chain", "prover": "host",
                   "warm_requests": 1, "trace_requests": 0,
                   "check_requests": 2},
    "sync_tiny": {"kind": "sync_batch", "batch": 2, "chain": 2,
                  "reject_every": 1, "warm_requests": 1,
                  "trace_requests": 1, "check_rejects": 1},
}


# what each kind of tiny cell reports: the suffix of its per-layer metrics
# and its end-to-end metrics, added to the copy where BENCHMARK.json has
# no cell of that kind
KIND_METRICS = {"verify_stream": ("verify", ["verify_ms", "verify_ms_p95"]),
                "prove_chain": ("prove", ["prove_ms"]),
                "sync_batch": ("sync", ["batch_proofs_per_s"])}
E2E_UNITS = {"verify_ms": ("ms", "lower"), "verify_ms_p95": ("ms", "lower"),
             "prove_ms": ("ms", "lower"),
             "batch_proofs_per_s": ("proofs/s", "higher")}
LAYERS = ("host_rest_ms", "decode_ms", "msm_ms", "launches_per_request",
          "kernel_roofline_share", "device_idle_share")


def make_copy(dest: Path) -> Path:
    """A checkout-like root at `dest`: the benchmark folder (without its
    tests) and a BENCHMARK.json whose cells are the tiny ones beside the
    real ones."""
    bench_dir = dest / "benchmark"
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    (bench_dir / "configs" / "tiny4.json").write_text(json.dumps(TINY_CONFIG))
    for name, mix in TINY_TRAFFIC.items():
        (bench_dir / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny4", "source": "tests",
                             "file": "benchmark/configs/tiny4.json",
                             "reduced": [], "why": "tests"})
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    layers = {m["name"]: m for m in bench["per_layer"]}
    for name, mix in TINY_TRAFFIC.items():
        cell = f"tiny4.{name}"
        bench["workloads"].append({"name": cell, "config": "tiny4",
                                   "traffic": name, "chips": 1,
                                   "why": "tests"})
        suffix, names = KIND_METRICS[mix["kind"]]
        for metric in names:
            unit, better = E2E_UNITS[metric]
            e2e.setdefault(metric, {"name": metric, "unit": unit,
                                    "better": better, "bound": 0.25,
                                    "source": "host_clock",
                                    "workloads": []})["workloads"].append(cell)
        for stem in LAYERS:
            entry = layers.setdefault(f"{stem}.{suffix}", dict(
                next(m for m in bench["per_layer"]
                     if m["name"].startswith(stem + ".")),
                name=f"{stem}.{suffix}", moves=names[0], workloads=[]))
            entry["workloads"].append(cell)
    bench["end_to_end"] = list(e2e.values())
    bench["per_layer"] = list(layers.values())
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest
