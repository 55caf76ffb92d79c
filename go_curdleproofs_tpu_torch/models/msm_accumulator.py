"""The verifier's MSM batching engine (go_curdleproofs_tpu/models/
msm_accumulator.py on the port's curve layer).

Every claimed identity C = <x, v> folds in with a fresh random alpha: the
points of x, v AND the commitment side (C, or a linear combination of proof
points, with scalar -alpha) all join one deduplicated base -> scalar map,
and `verify` checks that ONE MSM over everything is the identity (sound by
Schwartz-Zippel). Bases of the static CRS row [Gs|Hs] ride its cached
multiples table; the per-proof bases take one fresh table.

Base keys are points: host Affine tuples by value, LazyPoints by blob. The
two never compare equal, so a point appearing both ways takes two entries
whose MSM terms sum to the same total. Scalars accumulate unreduced and
possibly negative; digits reduce them mod r. The LazyPoints of one
DecodePool reach the final MSM as rows of its device points (`pool.pts`):
no host conversion or upload of a decoded point.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..ops import curve
from ..utils import field_host as fh
from ..utils import profiling
from ..utils.codec import LazyPoint, point_is_infinity
from ..utils.field_host import Affine
from ..utils.rand import Rand

LinComb = Sequence[Tuple[Affine, int]]
Commitment = Union[Affine, LinComb]


def as_terms(c: Commitment, coeff: int = 1) -> List[Tuple[Affine, int]]:
    """A point or a linear combination -> coeff-scaled term list."""
    if c is None:
        return []
    if isinstance(c, (tuple, LazyPoint)):
        return [(c, coeff)]
    return [(q, coeff * k % fh.R) for (q, k) in c]


class StaticBases:
    """A device base row with a prebuilt multiples table, plus the lane of
    each of its points."""

    def __init__(self, sv: curve.StackedVec, points: Sequence[Affine]):
        self.sv = sv
        self.index: Dict[Affine, int] = {}
        for i, p in enumerate(points):
            if p is not None and p not in self.index:
                self.index[p] = i


class MsmAccumulator:
    def __init__(self, *, device: torch.device,
                 static_bases: Optional[StaticBases] = None):
        self.device = device
        self._base_scalar: Dict[Affine, int] = {}
        self._static = static_bases

    def _bump(self, base: Affine, scalar: int) -> None:
        if point_is_infinity(base):
            return
        self._base_scalar[base] = self._base_scalar.get(base, 0) + scalar

    @profiling.traced("accumulate")
    def accumulate_check(self, c: Commitment, x: Sequence[int],
                         v: Sequence[Affine], rand: Rand) -> None:
        """Defer the check c == <x, v>."""
        if len(v) != len(x):
            raise ValueError("x and v must have the same length")
        alpha = rand.get_fr()
        for xi, vi in zip(x, v):
            self._bump(vi, alpha * xi)
        for (q, coeff) in as_terms(c):
            self._bump(q, -alpha * coeff)

    def _split_static(self):
        """(static-row scalars or None, dynamic bases, dynamic scalars, the
        device points of the dynamic rows). Only host Affine tuples route
        to the static row; the LazyPoints of the first pool met are rows of
        its device points (`DecodePool.row`), those of any other pool
        resolve to Affine."""
        st = self._static
        static_sc = [0] * (st.sv.width if st else 0)
        dyn_b: List[curve.Base] = []
        dyn_s: List[int] = []
        any_static = False
        pool = None
        for b, s in self._base_scalar.items():
            lane = st.index.get(b) if (st and isinstance(b, tuple)) else None
            if lane is not None:
                static_sc[lane] = (static_sc[lane] + s) % fh.R
                any_static = True
                continue
            if isinstance(b, LazyPoint):
                pool = pool or b.pool
                row = b.pool.row(b.blob) if b.pool is pool else None
                dyn_b.append(b.resolve() if row is None else row)
            else:
                dyn_b.append(b)
            dyn_s.append(s)
        return ((static_sc if any_static else None), dyn_b, dyn_s,
                (pool.pts if pool else None))

    def total(self) -> Affine:
        """The one deduplicated MSM: the static row off its cached table,
        the pool's points read on the device, host points uploaded."""
        static_sc, dyn_b, dyn_s, resident = self._split_static()
        if static_sc is not None:
            return curve.msm_with_static(self._static.sv, static_sc, dyn_b,
                                         dyn_s, resident=resident)
        return curve.msm(dyn_b, dyn_s, device=self.device, resident=resident)

    @profiling.traced("final_msm")
    def verify(self) -> bool:
        """One deduplicated MSM == identity. The first LazyPoint base
        materializes its pool here if nothing did before: one batched
        decompression for every deferred point."""
        if not self._base_scalar:
            return True
        return self.total() is None
