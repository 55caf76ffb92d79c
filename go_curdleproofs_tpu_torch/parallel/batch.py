"""Batched verification of Whisk shuffle proofs
(go_curdleproofs_tpu/parallel/batch.py on the port).

A node verifies many shuffle proofs an epoch. Two levers:
  * one shared accumulator: every deferred check of every proof folds in
    with its own fresh random alpha (soundness is per check, by
    Schwartz-Zippel, unchanged), so the whole batch ends in ONE final MSM;
  * one DecodePool: every proof point and tracker point of the batch is
    decoded in one batched decompression on the device.
The final MSM may itself be sharded over a process group (parallel.msm).
Every rank replays every transcript with the same seeded Rand, so the
alphas come in the same order on every rank and as in the JAX package;
only the final MSM is split.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..models import curdleproof, whisk
from ..models.msm_accumulator import MsmAccumulator, StaticBases
from ..utils import codec
from ..utils import profiling
from ..utils.rand import Rand
from . import msm as pmsm


class ShardedMsmAccumulator(MsmAccumulator):
    """An MsmAccumulator whose final MSM runs sharded over `group`; with no
    group, MsmAccumulator's own (the static CRS row off its cached table)."""

    def __init__(self, *, device: torch.device,
                 group: Optional[dist.ProcessGroup] = None,
                 static_bases: Optional[StaticBases] = None):
        super().__init__(device=device, static_bases=static_bases)
        self.group = group

    @profiling.traced("final_msm")
    def verify(self) -> bool:
        if self.group is None:
            return super().verify()
        bases = [codec.resolve_point(b) for b in self._base_scalar]
        scalars = list(self._base_scalar.values())
        if not bases:
            return True
        return pmsm.sharded_msm(bases, scalars, device=self.device,
                                group=self.group) is None


@profiling.traced("batch.verify_shuffle_proofs_batch")
def verify_shuffle_proofs_batch(crs: whisk.CRS, instances: Sequence[tuple],
                                rand: Rand, *, device: torch.device,
                                group: Optional[dist.ProcessGroup] = None
                                ) -> bool:
    """Verify many (pre_trackers, post_trackers, proof_bytes) instances
    with ONE batched decode and ONE deferred MSM for the whole batch.
    Malformed input (a length mismatch, bytes that do not decode, a zero
    randomizer) returns False; errors of the device propagate."""
    acc = ShardedMsmAccumulator(
        device=device, group=group,
        static_bases=curdleproof._gh_static(crs, device))
    pool = codec.DecodePool(device)
    parsed = []
    try:
        for pre_st, post_st, proof_bytes in instances:
            if len(pre_st) != len(post_st):
                return False
            wp = whisk.WhiskShuffleProof.from_bytes(proof_bytes, pool=pool)
            parsed.append((wp, whisk._pool_tracker_sets(pre_st, post_st,
                                                        pool)))
        for wp, (Rs, Ss, Ts, Us) in parsed:
            if codec.point_is_infinity(Ts[0]):
                return False
            if not curdleproof.verify(wp.proof, crs, Rs, Ss, Ts, Us, wp.m,
                                      rand, device=device, accumulator=acc):
                return False
        return acc.verify()
    except (ValueError, EOFError):
        return False
