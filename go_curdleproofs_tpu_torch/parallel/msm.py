"""The MSM sharded over the ranks of a torch.distributed process group
(go_curdleproofs_tpu/parallel/msm.py on the port's curve layer).

Every rank is given the same full lists and takes its own contiguous shard,
as the JAX package's single controller does with P(AXIS). Each rank sums
its shard's [1, W] windows on its own device (`curve._dynamic_windows`:
one table, one wide-phase launch a row of at most 4,096 bases); the ranks
all_gather the [W, 3, 12] int32 words; every rank adds the gathered rows
by a halving tree of `curve.add` (point addition is not a sum of words, so
all_reduce would be wrong) and runs the Horner tail on `windowed_combine`,
so every rank returns the same affine point. A rank whose shard is empty
gathers an infinity row: every rank enters the same collective once.
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..ops import curve
from ..utils import profiling
from ..utils.field_host import Affine


def init_file_group(path: str, *, rank: int, world_size: int, backend: str,
                    timeout_s: float = 60.0) -> dist.ProcessGroup:
    """Initialise the default process group from a FileStore at `path` (a
    file in a directory every rank sees, absent before the first rank
    comes), so that no port is needed. The caller names the backend: gloo
    for CPU tensors, NCCL for CUDA ones (one rank a card, with
    torch.cuda.set_device called first)."""
    store = dist.FileStore(path, world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


def make_group(ranks: Optional[Sequence[int]] = None) -> dist.ProcessGroup:
    """The group of `ranks` of the default group (every rank when None),
    the counterpart of make_mesh. A new group is a collective: every rank
    of the default group calls this with the same ranks."""
    world = dist.get_world_size()
    if ranks is None or sorted(ranks) == list(range(world)):
        return dist.group.WORLD
    return dist.new_group(sorted(ranks))


def _shard(n: int, rank: int, world: int) -> slice:
    per = -(-n // world)
    lo = min(rank * per, n)
    return slice(lo, min(lo + per, n))


@profiling.traced("msm")
def sharded_msm(points: Sequence[Affine], scalars: Sequence[int], *,
                device: torch.device,
                group: Optional[dist.ProcessGroup] = None) -> Affine:
    """<scalars, points> (scalars taken mod r) with every rank of `group`
    summing a contiguous shard on `device`; the same point on every rank.
    group None: one shard and no collective."""
    if len(points) != len(scalars):
        raise ValueError("sharded_msm: len(points) != len(scalars)")
    world = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    part = _shard(len(points), rank, world)
    if part.start < part.stop:
        windows = curve._dynamic_windows(points[part], scalars[part], device)
    else:
        windows = curve.infinity((1, curve.NUM_WINDOWS), device=device)
    if group is not None:
        local = torch.stack([c[0] for c in windows], dim=1).contiguous()
        rows = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(rows, local, group=group)        # [W, 3, 12] each
        stacked = torch.stack(rows)                      # [world, W, 3, 12]
        windows = curve.PointVec(*(stacked[:, :, i].contiguous()
                                   for i in range(3)))
    return curve.to_affine_host(curve.horner(curve._sum_rows(windows)))[0]
