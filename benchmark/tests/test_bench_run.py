"""The command itself: no card, no result; on the card, one short run."""

import json
import os
import subprocess
import sys

import pytest

from bench_copy import ROOT

RUN = [sys.executable, str(ROOT / "benchmark" / "run.py"),
       "--workload", "whisk124.verify_stream", "--seed", "4294967311",
       "--seconds", "2", "--trace", "0"]


def test_no_card_no_result():
    """With no card visible the run fails and prints nothing on stdout:
    it never falls back to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(RUN, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_no_program_no_result(tmp_path):
    """In a directory with the benchmark and nothing of the program the
    run fails."""
    import shutil
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    cmd = [sys.executable, str(tmp_path / "benchmark" / "run.py")] + RUN[2:]
    res = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.cuda
def test_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run(RUN, cwd=ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert {"verify_ms", "verify_ms_p95", "setup_s"} <= set(line["metrics"])
