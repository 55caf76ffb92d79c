"""The output check's plumbing: the reference's worker processes and the
limits each compared number is held to.

The reference runs in plain child processes (`python -m
benchmark.reference.worker`), each started, fed and waited for here: jobs
go in on its standard input and answers come back on its standard output.
Every child is waited for before `reference_answers` returns, and killed
and waited for on any error or timeout; each also dies with its parent.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Sequence

from .spec import REPO_ROOT

# the check's seconds after the window, at most: a run ends within 360 s
REFERENCE_TIMEOUT_S = 200.0


@dataclass
class Check:
    """One compared number beside its limit: `at_most` (value <= limit)
    or else at least (value >= limit)."""
    name: str
    value: int
    limit: int
    at_most: bool = True

    @property
    def ok(self) -> bool:
        return self.value <= self.limit if self.at_most \
            else self.value >= self.limit

    def line(self) -> str:
        rel = "<=" if self.at_most else ">="
        return (f"check {self.name}: {self.value} (limit {rel} {self.limit})"
                f" {'ok' if self.ok else 'FAILED'}")


def default_workers() -> int:
    """Processes for the reference: the cores this process may use, one
    left for the parent."""
    return max(1, min(7, len(os.sched_getaffinity(0)) - 1))


def start_worker() -> subprocess.Popen:
    """One reference worker, a child of this process; see
    reference/worker.py for what it reads and writes."""
    return subprocess.Popen(
        [sys.executable, "-m", "benchmark.reference.worker", str(os.getpid())],
        cwd=REPO_ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def end_workers(procs: Sequence[subprocess.Popen]) -> None:
    """Kill each worker that still runs, then wait for every one."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
    for proc in procs:
        proc.wait()
        for pipe in (proc.stdin, proc.stdout, proc.stderr):
            if pipe:
                pipe.close()


def reference_answers(ell: int, crs_seed: int, jobs: Sequence[Dict],
                      workers: int,
                      timeout: float = REFERENCE_TIMEOUT_S) -> List:
    """The reference's answer to each job, in order, from up to `workers`
    child processes, each with the CRS made from `crs_seed` and a share of
    the jobs dealt round. Raises if a worker fails or the time runs out."""
    if not jobs:
        return []
    n = max(1, min(workers, len(jobs)))
    shares = [list(range(i, len(jobs), n)) for i in range(n)]
    deadline = time.monotonic() + timeout
    procs: List[subprocess.Popen] = []
    answers: List = [None] * len(jobs)
    try:
        for _ in shares:
            procs.append(start_worker())
        for proc, share in zip(procs, shares):
            head = {"ell": ell, "crs_seed": crs_seed, "jobs": len(share)}
            proc.stdin.write("".join(json.dumps(x) + "\n" for x in
                                     [head] + [jobs[i] for i in share]))
            proc.stdin.flush()
        for proc, share in zip(procs, shares):
            out, err = proc.communicate(
                timeout=max(0.0, deadline - time.monotonic()))
            lines = out.splitlines()
            if proc.returncode != 0 or len(lines) != len(share):
                raise RuntimeError(
                    f"reference worker {proc.pid} exited {proc.returncode} "
                    f"with {len(lines)} of {len(share)} answers:\n"
                    f"{err[-2000:]}")
            for i, line in zip(share, lines):
                answers[i] = json.loads(line)
    finally:
        end_workers(procs)
    return answers
