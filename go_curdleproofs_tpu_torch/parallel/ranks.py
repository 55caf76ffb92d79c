"""Run one function on k ranks of this host, each in a spawned process with
a process group of its own making (a FileStore in a temporary directory:
no port, no network).

    results = spawn_ranks(msm.sharded_msm, 4, backend="gloo",
                          args=(points, scalars))

Each rank calls fn(*args, device=torch.device("cpu"), group=...) with the
whole group; spawn_ranks returns what each returned, in rank order. fn and
its arguments are pickled, so fn lives at the top level of an importable
module that does not import jax (a spawned process imports fn's module). The parent waits at
most `timeout_s` and then kills the ranks and raises, so a rank stuck in a
collective fails the caller instead of hanging it.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import msm as pmsm


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str,
               tmp: str, args: Sequence) -> None:
    torch.set_num_threads(1)
    group = pmsm.init_file_group(os.path.join(tmp, "store"), rank=rank,
                                 world_size=world_size, backend=backend)
    try:
        out = fn(*args, device=torch.device("cpu"), group=group)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, *, backend: str,
                args: Sequence = (), timeout_s: float = 120.0) -> List[Any]:
    """fn on `world_size` spawned ranks; their results in rank order."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, backend, tmp, tuple(args)),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks of "
                                       f"{fn.__name__} did not finish in "
                                       f"{timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        out = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
