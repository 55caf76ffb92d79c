"""Shared building blocks of the device-resident prover (counterpart of
go_curdleproofs_tpu/models/device_common.py): Fr plumbing, device
transcript absorption, masked vector helpers, the one fetch.

Everything here stays on the device: Fr scalars as [n, 8] elements
(ops/fr.py), points as PointVecs, and the STROBE transcript as an
ops/strobe_dev.py `TState`, so prover pieces chain with no host round
trip.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from ..ops import compress_dev, fp, fr, glv_dev, kernels, strobe_dev
from ..ops.curve import PointVec
from ..utils import codec
from ..utils import field_host as fh
from ..utils import profiling
from ..utils.field_host import Affine
from ..utils.transcript import Transcript

# transcript labels (the host modules' and the Go reference's, byte for byte)
LABEL_STEP1 = b"ipa_step1"
LABEL_ALPHA = b"ipa_alpha"
LABEL_BETA = b"ipa_beta"
LABEL_LOOP = b"ipa_loop"
LABEL_GAMMA = b"ipa_gamma"

SM_LABEL_STEP1 = b"same_msm_step1"
SM_LABEL_ALPHA = b"same_msm_alpha"
SM_LABEL_LOOP = b"same_msm_loop"
SM_LABEL_GAMMA = b"same_msm_gamma"


def fr_const(vals: Sequence[int], device: torch.device) -> torch.Tensor:
    return fr.from_ints([int(v) % fh.R for v in vals], device)


def fr_scalar(v: int, device: torch.device) -> torch.Tensor:
    return fr.from_ints([int(v) % fh.R], device)


def challenge_to_fr(chal_be: torch.Tensor) -> torch.Tensor:
    """32 big-endian challenge bytes -> a [1, 8] element."""
    return fr.from_bytes_be(chal_be[None])


def fr_digits(x: torch.Tensor) -> torch.Tensor:
    """[..., n, 8] elements -> [..., 2n, NUM_WINDOWS] interleaved signed
    GLV window digits, computed on the device (ops/glv_dev.py)."""
    return glv_dev.glv_split_digits(x)


def fr_bytes_be(x: torch.Tensor) -> torch.Tensor:
    """[n, 8] elements -> [n, 32] uint8 big-endian bytes."""
    return fr.canonical_bytes_be(x)


def scalar_rows(vals: Sequence[int]) -> np.ndarray:
    """Host scalars -> [n, 32] uint8 rows as the transcript absorbs them."""
    return np.stack([np.frombuffer(codec.fr_to_bytes(int(v) % fh.R), np.uint8)
                     for v in vals])


def point_rows(pts: Sequence[Affine]) -> np.ndarray:
    """Host points -> [n, 48] uint8 rows as the transcript absorbs them."""
    return np.stack([np.frombuffer(codec.g1_to_bytes(p), np.uint8)
                     for p in pts])


def append_scalars_dev(ts: strobe_dev.TState, label: bytes,
                       x: torch.Tensor) -> None:
    """Absorb each row of x as a 32-byte big-endian scalar
    (transcript.append_scalars) in one launch."""
    ts.append_rows(label, fr_bytes_be(x))


def append_points_dev(ts: strobe_dev.TState, label: bytes,
                      pv: PointVec) -> None:
    """Compress points on the device and absorb them
    (transcript.append_points)."""
    ts.append_rows(label, compress_dev.compress(pv))


def challenge_fr(ts: strobe_dev.TState, label: bytes) -> torch.Tensor:
    return challenge_to_fr(ts.get_and_append_challenge(label))


def transcript_to_device(t: Transcript,
                         device: torch.device) -> strobe_dev.TState:
    """Host transcript -> its state on `device`, with the host-known
    positions."""
    s = t.inner.strobe
    return strobe_dev.TState(
        strobe_dev.bytes_tensor(bytes(s.state), device), s.pos, s.pos_begin)


def sync_host_transcript(transcript: Transcript, st_bytes: np.ndarray,
                         pos: int, pos_begin: int) -> None:
    """Adopt a fetched device transcript state; pos / pos_begin are the
    static positions after the last device challenge."""
    s = transcript.inner.strobe
    s.state[:] = np.asarray(st_bytes, np.uint8).tobytes()
    s.pos, s.pos_begin, s.cur_flags = int(pos), int(pos_begin), 0


def roll_fr(vec: torch.Tensor, shift: int) -> torch.Tensor:
    return torch.roll(vec, shift, 0)


def lane_index(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def masked_inner(a: torch.Tensor, b: torch.Tensor, h: int) -> torch.Tensor:
    """<a[..., 0:h], b[..., 0:h]> over [..., n, 8]; returns [..., 8]."""
    keep = (lane_index(a.shape[-2], a.device) < h)[:, None]
    return fr.inner_product(torch.where(keep, a, 0), b)


def stack_points(pvs: List[PointVec]) -> PointVec:
    """Concatenate [k_i]-point batches (a single point counts as [1])."""
    def cat(i):
        return torch.cat([p[i] if p[i].ndim > 1 else p[i][None] for p in pvs])

    return PointVec(cat(0), cat(1), cat(2))


def take_points(pv: PointVec, idx: Sequence[int]) -> PointVec:
    """The points pv[idx[0]], pv[idx[1]], ... as a fresh contiguous batch."""
    return stack_points([PointVec(*(t[i:i + 1] for t in pv)) for i in idx])


def point_at(pv: PointVec, i: int) -> PointVec:
    """pv[i:i+1], a [1]-point batch (a contiguous view)."""
    return PointVec(*(t[i:i + 1] for t in pv))


def points_equal(p: PointVec, q: PointVec) -> torch.Tensor:
    """Projective equality as a [n] bool (cross-multiplication)."""
    d1 = fp.sub(fp.mul(p.x, q.z), fp.mul(q.x, p.z))
    d2 = fp.sub(fp.mul(p.y, q.z), fp.mul(q.y, p.z))
    return fp.is_zero(d1) & fp.is_zero(d2)


def kernel_launches() -> int:
    """Hand-written kernel launches in this process so far (the counters of
    ops/kernels.py)."""
    return sum(kernels.launches.values())


def enqueue(chain: Callable, *args):
    """chain(*args), the host's enqueue of a prover's device chain, in a
    `chain` span. While spans record, the span's counter `chain.kernels` is
    the number of hand-written kernel launches enqueued inside it."""
    with profiling.span("chain") as sp:
        before = kernel_launches() if sp else 0
        out = chain(*args)
        if sp:
            profiling.count("chain.kernels", kernel_launches() - before)
    return out


def fetch(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """The prover's one download: every tensor (uint8, or bool as bytes)
    packed into one buffer on the device, one copy to the host, split back
    into arrays of the tensors' shapes."""
    flat = torch.cat([t.to(torch.uint8).reshape(-1) for t in tensors])
    with profiling.span("fetch"):
        host = flat.cpu()
    host = host.numpy()
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(host[off:off + n].reshape(tuple(t.shape)))
        off += n
    return out


def scalar_of(row_be: np.ndarray) -> int:
    """A fetched 32-byte big-endian scalar row -> int."""
    return int.from_bytes(np.asarray(row_be, np.uint8).tobytes(), "big")
