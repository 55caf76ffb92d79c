"""The reference's work in a child process of a run.

    python -m benchmark.reference.worker <parent pid>

Standard input holds one JSON object a line: first a header
{"ell", "crs_seed", "jobs": k}, then k jobs. The worker reads all of them
before it works, so that its parent can hand every worker its share at
once; then it makes its CRS from the seed and writes one JSON answer a
line to standard output, in the jobs' order. Bytes travel as hex.

Jobs:
  {"op": "verify", "pre", "post", "proof", "seed"} -> bool
  {"op": "check_prove", "pre", "post", "proof", "rand_seed", "seed"}
      -> [the proof verifies, trackers that are not the request's shuffle]

At its start the worker asks the kernel to kill it when its parent dies
(prctl PR_SET_PDEATHSIG), and then checks that its parent is still the
pid it was handed: a run that is killed leaves no worker behind. It
imports nothing outside benchmark/reference/.
"""

from __future__ import annotations

import ctypes
import json
import os
import random
import signal
import sys
from typing import Dict, List, Sequence, Tuple

from . import bls, curdleproofs

PR_SET_PDEATHSIG = 1


def die_with_parent(parent: int) -> None:
    """SIGKILL this process when its parent ends; exit at once if the
    parent has already gone."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_PDEATHSIG, int(signal.SIGKILL), 0, 0, 0) != 0:
        err = ctypes.get_errno()
        raise OSError(err, f"prctl(PR_SET_PDEATHSIG): {os.strerror(err)}")
    if os.getppid() != parent:
        os._exit(3)


def _trackers(pairs) -> List[Tuple[bytes, bytes]]:
    return [(bytes.fromhex(a), bytes.fromhex(b)) for a, b in pairs]


def encode_trackers(trackers: Sequence[Tuple[bytes, bytes]]) -> List:
    return [[bytes(a).hex(), bytes(b).hex()] for a, b in trackers]


def run_job(crs: curdleproofs.CRS, decode: bls.Decoder, job: Dict):
    pre, post = _trackers(job["pre"]), _trackers(job["post"])
    proof = bytes.fromhex(job["proof"])
    ok = curdleproofs.verify_shuffle(crs, pre, post, proof, decode,
                                     random.Random(job["seed"]))
    if job["op"] == "verify":
        return ok
    if job["op"] == "check_prove":
        return [ok, curdleproofs.shuffle_mismatches(pre, post,
                                                    job["rand_seed"], decode)]
    raise ValueError(f"no job {job['op']!r}")


def main(argv: Sequence[str]) -> int:
    die_with_parent(int(argv[0]))
    header = json.loads(sys.stdin.readline())
    jobs = [json.loads(sys.stdin.readline()) for _ in range(header["jobs"])]
    crs = curdleproofs.make_crs(header["ell"], header["crs_seed"])
    decode = bls.Decoder()                  # memoised over this worker's jobs
    for job in jobs:
        sys.stdout.write(json.dumps(run_job(crs, decode, job)) + "\n")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
