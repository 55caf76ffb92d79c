"""No process outlives a run: the reference's workers are waited for, die
with their parent, and the guard before the result line refuses to print
while a child lives. Nothing of the benchmark starts processes any other
way.

The drivers' runs go through the harness's own entry (runner.prepare /
measure and run.finish) at ELL=4 on the CPU, each in a child that leads a
session of its own; once it has exited, no process of that session may be
left.
"""

import ast
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark import run
from benchmark.core import check

from bench_copy import BENCH, ROOT

SEED = 2 ** 33 + 11
KINDS = {"verify_stream": "tiny4.verify_tiny",
         "prove_chain": "tiny4.prove_tiny",
         "sync_batch": "tiny4.sync_tiny"}

# one run of a tiny cell, as run.py ends it; a verify window holds two
# requests, so that one of them is the wrong pairing
ONE_RUN = """
import sys, time
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from pathlib import Path
from benchmark import run
from benchmark.core import runner, spec
cpu = torch.device("cpu")
cell = spec.load_cell(sys.argv[2], root=Path(sys.argv[3]))
drv = runner.prepare(cell, int(sys.argv[4]), device=cpu, workers=2)
seconds = 0.01
if cell.traffic["kind"] == "verify_stream":
    t0 = time.perf_counter()
    drv.request(0).run()
    seconds = 1.6 * (time.perf_counter() - t0)
result, checks = runner.measure(cell, drv, seconds, False, device=cpu,
                                setup_s=1.0)
sys.exit(run.finish(result, checks))
"""


def _stat(pid: int):
    """(state, ppid, session) of a live process, else None."""
    try:
        text = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return None
    state, ppid, _, session = text.rsplit(")", 1)[1].split()[:4]
    return state, int(ppid), int(session)


def _session(sid: int):
    """Every process of session `sid`, zombies with them."""
    out = []
    for entry in Path("/proc").iterdir():
        if entry.name.isdigit():
            st = _stat(int(entry.name))
            if st and st[2] == sid:
                out.append((int(entry.name), st[0]))
    return out


def _gone(pid: int, seconds: float) -> bool:
    """The process has ended (or is a zombie no one reaps) within
    `seconds`."""
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        st = _stat(pid)
        if st is None or st[0] == "Z":
            return True
        time.sleep(0.05)
    return False


@pytest.mark.parametrize("kind", [
    pytest.param(k, marks=pytest.mark.xdist_group("session_" + k))
    for k in sorted(KINDS)])
def test_a_run_leaves_no_process_in_its_session(tiny_root, tmp_path, kind):
    # output to files, not pipes: a process left behind would hold a pipe
    # open and keep the test waiting instead of failing it
    out_path, err_path = tmp_path / "out", tmp_path / "err"
    with open(out_path, "w") as out_f, open(err_path, "w") as err_f:
        proc = subprocess.Popen(
            [sys.executable, "-c", ONE_RUN, str(ROOT), KINDS[kind],
             str(tiny_root), str(SEED)],
            cwd=ROOT, stdout=out_f, stderr=err_f, start_new_session=True)
    try:
        proc.wait(timeout=900)
        left = _session(proc.pid)
    finally:
        if _session(proc.pid):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    out, err = out_path.read_text(), err_path.read_text()
    assert proc.returncode == 0, err[-3000:]
    assert '"correct": true' in out.strip().splitlines()[-1], err[-3000:]
    assert left == []


def test_a_worker_dies_with_its_parent():
    """The parent starts a worker and sleeps; SIGKILL on the parent ends
    the worker too, though nothing waits for it."""
    code = ("import sys, time; sys.path.insert(0, sys.argv[1]); "
            "from benchmark.core.check import start_worker; "
            "w = start_worker(); print(w.pid, flush=True); time.sleep(300)")
    parent = subprocess.Popen([sys.executable, "-c", code, str(ROOT)],
                              stdout=subprocess.PIPE, text=True,
                              start_new_session=True)
    try:
        worker = int(parent.stdout.readline())
        time.sleep(3)            # the worker has set its signal and reads
        assert _stat(worker) and _stat(worker)[1] == parent.pid
        parent.kill()
        parent.wait()
        assert _gone(worker, 10)
    finally:
        if _session(parent.pid):
            os.killpg(parent.pid, signal.SIGKILL)
        parent.wait()
        parent.stdout.close()


def test_a_worker_whose_parent_has_gone_exits_at_once():
    """A worker handed a pid that is not its parent's ends before it
    reads anything."""
    res = subprocess.run(
        [sys.executable, "-m", "benchmark.reference.worker", "1"],
        cwd=ROOT, input="", capture_output=True, text=True, timeout=60)
    assert res.returncode == 3 and res.stdout == ""


def test_workers_are_waited_for_when_the_time_runs_out(monkeypatch):
    started = []
    real = check.start_worker
    monkeypatch.setattr(check, "start_worker",
                        lambda: started.append(real()) or started[-1])
    job = {"op": "verify", "pre": [], "post": [], "proof": "", "seed": 0}
    with pytest.raises(subprocess.TimeoutExpired):
        check.reference_answers(508, 1, [job] * 4, 2, timeout=0.2)
    assert len(started) == 2
    assert all(p.returncode is not None for p in started)


def test_a_failing_worker_fails_the_check_and_is_waited_for(monkeypatch):
    started = []
    real = check.start_worker
    monkeypatch.setattr(check, "start_worker",
                        lambda: started.append(real()) or started[-1])
    jobs = [{"op": "verify", "pre": [], "post": [], "proof": "",
             "seed": 0}, {"op": "no_such_job", "pre": [], "post": [],
                          "proof": "", "seed": 0}]
    with pytest.raises(RuntimeError, match="no_such_job"):
        check.reference_answers(4, 1, jobs, 2)
    assert all(p.returncode is not None for p in started)


GUARD = """
import subprocess, sys
sys.path.insert(0, sys.argv[1])
from benchmark import run
from benchmark.core.check import Check
if sys.argv[2] == "plant":
    child = subprocess.Popen(["sleep", "300"])
    print("planted", child.pid, file=sys.stderr, flush=True)
sys.exit(run.finish({"correct": True}, [Check("verdict_mismatches", 0, 0)]))
"""


def test_the_guard_refuses_a_result_while_a_child_lives():
    res = subprocess.run([sys.executable, "-c", GUARD, str(ROOT), "plant"],
                         capture_output=True, text=True, timeout=60,
                         start_new_session=True)
    assert res.returncode != 0 and res.stdout == ""
    planted = int(res.stderr.split("planted")[1].split()[0])
    assert f"[{planted}]" in res.stderr and "no result" in res.stderr
    assert "check verdict_mismatches" not in res.stderr
    assert _gone(planted, 5)


def test_the_guard_prints_the_result_when_no_child_lives():
    res = subprocess.run([sys.executable, "-c", GUARD, str(ROOT), "none"],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0
    assert res.stdout.strip() == '{"correct": true}'
    assert res.stderr.strip().splitlines()[-1].startswith(
        "check verdict_mismatches: 0")


def test_the_guard_sees_a_child_of_another_thread():
    """/proc/self/task/*/children lists the children of every thread."""
    import threading
    box = []
    t = threading.Thread(target=lambda: box.append(
        subprocess.Popen(["sleep", "300"])))
    t.start()
    t.join()
    try:
        assert box[0].pid in run.live_children()
    finally:
        box[0].kill()
        box[0].wait()
    assert box[0].pid not in run.live_children()


# what would start a process that the run does not wait for
NO_MODULES = {"multiprocessing", "concurrent.futures", "torch.multiprocessing"}
NO_CALLS = {("os", "fork"), ("os", "forkpty"), ("pty", "fork")}


def _process_starters(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if any(alias.name == m or alias.name.startswith(m + ".")
                       for m in NO_MODULES):
                    yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mod = node.module or ""
            names = {f"{mod}.{a.name}" for a in node.names}
            for m in NO_MODULES:
                if mod == m or mod.startswith(m + ".") or m in names:
                    yield mod
            if mod in ("os", "pty") and {"fork", "forkpty"} & {
                    a.name for a in node.names}:
                yield mod + ".fork"
        elif (isinstance(node, ast.Attribute)
              and isinstance(node.value, ast.Name)
              and (node.value.id, node.attr) in NO_CALLS):
            yield f"{node.value.id}.{node.attr}"


MODULES = sorted(p for p in BENCH.rglob("*.py")
                 if "tests" not in p.relative_to(BENCH).parts)


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_starts_a_process_that_is_not_waited_for(path):
    assert list(_process_starters(path)) == []


@pytest.mark.parametrize("source", [
    "import multiprocessing", "import concurrent.futures.process",
    "from concurrent.futures import ProcessPoolExecutor",
    "from concurrent import futures", "import torch.multiprocessing as mp",
    "from torch import multiprocessing", "import os\nos.fork()",
    "from os import fork"])
def test_the_scan_finds_each_kind_of_starter(tmp_path, source):
    path = tmp_path / "m.py"
    path.write_text(source + "\n")
    assert list(_process_starters(path))
