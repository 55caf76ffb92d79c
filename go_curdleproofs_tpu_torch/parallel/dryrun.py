"""The port's multi-device paths at protocol scale, as the JAX package's
__graft_entry__.dryrun_multichip runs them:

  1. the sharded MSM over 1,024 distinct full-range bases and scalars,
     checked against the host oracle fh.g1_msm;
  2. the caller's Whisk shuffle proofs (chip_smoke.py passes both ELL=124
     proofs of its fixture) through verify_shuffle_proofs_batch, its final
     MSM sharded over the same group.

Every rank of `group` calls dryrun with the same arguments. Any mismatch
raises.
"""

from __future__ import annotations

import random
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..models import whisk
from ..utils import field_host as fh
from ..utils.rand import Rand
from . import batch as pbatch
from . import msm as pmsm

N_BASES = 1024


def dryrun(crs: whisk.CRS, instances: Sequence[tuple], *,
           device: torch.device,
           group: Optional[dist.ProcessGroup] = None) -> None:
    """instances: (pre_trackers, post_trackers, proof_bytes) under `crs`,
    every one of them valid."""
    rng = random.Random(1)
    pts = [fh.g1_mul(fh.G1_GEN, rng.randrange(1, fh.R))
           for _ in range(N_BASES)]
    scalars = [rng.randrange(fh.R) for _ in range(N_BASES)]
    got = pmsm.sharded_msm(pts, scalars, device=device, group=group)
    if got != fh.g1_msm(pts, scalars):
        raise RuntimeError("sharded MSM differs from the host oracle")
    if not pbatch.verify_shuffle_proofs_batch(crs, instances, Rand(9),
                                              device=device, group=group):
        raise RuntimeError("sharded batched verification failed")
