"""BLS12-381 G1 points, the verifier's and the prover's MSMs over torch
tensors.

Points are homogeneous projective (X : Y : Z) under the complete formulas of
Renes-Costello-Batina 2016 (a = 0, b3 = 12), as in the JAX package's
ops/curve.py: no branch for infinity or doubling. A `PointVec` holds three
`[..., 12]` element tensors (ops/fp.py).

Scalar multiplication and MSM are GLV-decomposed with signed 4-bit digits
(ops/glv.py): lanes extend 2x (lane 2i = P_i, lane 2i+1 = phi(P_i)), 33
windows, 9-entry multiples tables with free negation. Every point
operation goes through a kernel wrapper of ops/kernels.py: `add` and
`double` (table builds, the GLV halves' add, the add of static and dynamic
window sums) through `point_add` / `point_double`, the MSM wide phase
through `msm_select_reduce` (one wrapper call; wide rows are split over
blocks and finished by a second small launch inside it), the Horner tail
through `windowed_combine` (one launch, its time the same from 1 row to
2048). In both a group of 8 lanes shares each point operation.

A per-point scalar multiplication has two forms: `scalar_mul_device` (all
windows selected, one `windowed_combine` launch) and `scalar_mul_steps`
(the window-at-a-time loop on the fused `point_x16_add` step, which
selects its own table entry: one launch a window), which the
device-resident prover uses for its handful-of-points multiplications.

The host prover's device API is `StackedVec.msm_many` (one wide-phase launch
over all (job, base row) terms, one Horner launch, one fetch) behind the
scalar-side folding view `FoldedBases`, plus `msm_batch` and
`batch_scalar_mul`.

Every host-facing MSM, `batch_scalar_mul` and the folds' gammas recode
their host scalars through `recode`: the host writes each scalar (mod r)
as 32 little-endian bytes, pad lanes as zero bytes, uploads them once,
and the `glv_recode` kernel (ops/kernels.py) splits and recodes all of a
call's rows in one launch, on the CPU its plain version.

Spans (utils/profiling.py): `msm` around each host-facing MSM and
`batch_scalar_mul`, with the children `recode` (the host's preparation
of a call's scalars, with its counters `recode.scalars`, the scalars
recoded, pad lanes included, and `recode.on_card`, those the kernel
recoded: all of them on a CUDA device, none on the CPU), `upload`
(`affine_planes`, and the scalars' words after `recode`), `fetch`
(the blocking copy back) and `convert` (host normalisation of what came
back), and the counters `msm.terms` (bases with a non-zero scalar),
`msm.lanes` (base lanes launched: rows x padded width), and in `msm` and
`msm_with_static` `msm.resident` (fresh-table bases read from device
points by row: a decode's, which the verifier's final MSM passes) and
`msm.uploaded` (host Affine bases converted and uploaded); `expand` around
`FoldedBases`' scalar-side folding and `fold` around `StackedVec.fold`.
"""

from __future__ import annotations

from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from ..utils import field_host as fh
from ..utils import profiling
from ..utils.field_host import Affine
from . import fp, fr, glv, halflimb, kernels

B3 = 12                         # 3*b for y^2 = x^3 + 4
WINDOW_BITS = glv.WINDOW_BITS
NUM_WINDOWS = glv.NUM_WINDOWS   # 33 signed GLV windows
TABLE_SIZE = glv.TABLE_SIZE     # digit magnitudes 0..8


class PointVec(NamedTuple):
    """A batch of projective G1 points: three [..., 12] element tensors."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @property
    def batch_shape(self):
        return self.x.shape[:-1]


def pmap(fn: Callable[[torch.Tensor], torch.Tensor], p: PointVec) -> PointVec:
    return PointVec(fn(p.x), fn(p.y), fn(p.z))


def infinity(shape=(), *, device: torch.device) -> PointVec:
    return PointVec(fp.zeros(shape, device=device),
                    fp.constant(1, shape, device=device),
                    fp.zeros(shape, device=device))


def add(p: PointVec, q: PointVec) -> PointVec:
    """Complete projective addition (RCB16 algorithm 7, a = 0) through the
    `point_add` kernel wrapper: contiguous coordinates of one shape."""
    return kernels.point_add(p, q)


def double(p: PointVec) -> PointVec:
    """Complete projective doubling (RCB16 algorithm 9, a = 0) through the
    `point_double` kernel wrapper."""
    return kernels.point_double(p)


def x16_add(acc: PointVec, sel: PointVec) -> PointVec:
    """16 * acc + sel, the serial step of a window-at-a-time Horner loop,
    through the `point_x16_add` kernel wrapper."""
    return kernels.point_x16_add(acc, sel)


def neg(p: PointVec) -> PointVec:
    return PointVec(p.x, fp.neg(p.y), p.z)


def select(mask: torch.Tensor, p: PointVec, q: PointVec) -> PointVec:
    return PointVec(fp.where(mask, p.x, q.x), fp.where(mask, p.y, q.y),
                    fp.where(mask, p.z, q.z))


def _stack_points(ps: Sequence[PointVec]) -> PointVec:
    return PointVec(torch.stack([q.x for q in ps]),
                    torch.stack([q.y for q in ps]),
                    torch.stack([q.z for q in ps]))


def _unstack_points(pv: PointVec) -> List[PointVec]:
    return [PointVec(*c) for c in zip(pv.x, pv.y, pv.z)]


# -- host <-> device ------------------------------------------------------------

@profiling.traced("upload")
def affine_planes(pts: Sequence[Affine], *,
                  device: torch.device) -> torch.Tensor:
    """Host affine points -> [3, n, 12]: the planes X, Y, Z of each point
    (infinity -> (0:1:0)), Montgomery conversion on the host, one upload."""
    n = len(pts)
    return fp.from_ints([(pt[0] if pt else 0) for pt in pts]
                        + [(pt[1] if pt else 1) for pt in pts]
                        + [(1 if pt else 0) for pt in pts],
                        device).view(3, n, fp.NWORDS)


def from_affine_host(pts: Sequence[Affine], *,
                     device: torch.device) -> PointVec:
    """Host affine points -> [n] PointVec (infinity -> (0:1:0)): its
    coordinates are the planes of one `affine_planes` upload."""
    return PointVec(*affine_planes(pts, device=device))


def to_affine_host(p: PointVec) -> List[Affine]:
    """Projective -> host affine over the flattened batch: one stacked
    device-to-host copy, then one host batch inversion (Z == 0 is
    infinity, whatever Y holds)."""
    ints = fp.to_ints(torch.stack([p.x, p.y, p.z]))
    n = len(ints) // 3
    xs, ys, zs = ints[:n], ints[n:2 * n], ints[2 * n:]
    out: List[Affine] = []
    with profiling.span("convert"):
        for x, y, zi in zip(xs, ys, fh.fp_batch_inv(zs)):
            out.append(None if zi == 0 else (x * zi % fh.P, y * zi % fh.P))
    return out


def to_affine_host_single(p: PointVec) -> Affine:
    """One projective point (coordinates [12] or [1, 12]) -> host affine."""
    return to_affine_host(pmap(lambda t: t.reshape(1, fp.NWORDS), p))[0]


def to_affine_host_xy(p: PointVec) -> List[Affine]:
    """Projective -> host affine with the normalisation done on the device
    (compress_dev.compress_xy: the inverse ladder kernel, two products):
    96 bytes per point come back and the host only recomposes ints."""
    from . import compress_dev
    rows = compress_dev.compress_xy(p)
    with profiling.span("fetch"):
        rows = rows.cpu()
    with profiling.span("convert"):
        return [compress_dev.decode_xy_host(r) for r in rows.numpy()]


# -- GLV recoding of host scalars ------------------------------------------------

ScalarRow = Tuple[Sequence[int], int, int]    # (scalars, offset, width)


def _scalar_words(rows: Sequence[ScalarRow]) -> np.ndarray:
    """[lanes, 8] int32: row after row, `width` lanes each, the scalars
    (ints of any sign or size, taken mod r) as little-endian words from
    `offset` on, zero words in the other lanes."""
    r = fh.R
    parts = []
    for scalars, offset, width in rows:
        parts.append(bytes(32 * offset))
        try:        # Python ints: no int() call a scalar (a third of it)
            parts.extend([(s % r).to_bytes(32, "little") for s in scalars])
        except OverflowError:           # numpy or torch integers
            parts.extend([(int(s) % r).to_bytes(32, "little")
                          for s in scalars])
        parts.append(bytes(32 * (width - offset - len(scalars))))
    return np.frombuffer(bytearray().join(parts),
                         np.int32).reshape(-1, fr.NWORDS)


def recode(rows: Sequence[ScalarRow], device: torch.device, *,
           bases: bool = True) -> torch.Tensor:
    """The GLV digits of rows of host scalars (`_scalar_words`'s layout):
    one upload of their 32-byte words and one `glv_recode` launch ->
    [2 * lanes, NUM_WINDOWS] int32 on `device`, lane i's s1 and s2 in rows
    2i and 2i + 1, MSB window first. The `recode` span holds the host's
    part, the words; the kernel on a CUDA device recodes them
    (`recode.on_card`), its plain version elsewhere. `bases`: the lanes
    are an MSM's bases, counted in `msm.lanes` and `msm.terms` (those
    whose scalar is not zero mod r)."""
    with profiling.span("recode"):
        words = _scalar_words(rows)
        profiling.count("recode.scalars", len(words))
        profiling.count("recode.on_card", len(words) if torch.device(
            device).type == "cuda" else 0)
    with profiling.span("upload"):
        on_dev = halflimb.upload(words, torch.int32, device)
    if bases and profiling.recording():
        profiling.count("msm.lanes", len(words))
        profiling.count("msm.terms",
                        int(np.count_nonzero(words.any(axis=1))))
    return kernels.glv_recode(on_dev)


# -- GLV tables, select and reduce ----------------------------------------------

def _beta_elem(device: torch.device) -> torch.Tensor:
    """The GLV cube root of unity beta (phi(x, y) = (beta*x, y))."""
    return fp.constant(glv.BETA, device=device)


def _interleave2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., n, 12] x2 -> [..., 2n, 12] with rows a0, b0, a1, b1, ..."""
    st = torch.stack([a, b], dim=-2)                  # [..., n, 2, 12]
    return st.flatten(-3, -2)


def extend_table_glv(table: PointVec) -> PointVec:
    """[T, ..., n] multiples table -> [T, ..., 2n] with phi lanes
    interleaved: phi(d*P) = d*phi(P), so one multiply of the x plane."""
    bx = fp.mul(table.x, _beta_elem(table.x.device))
    return PointVec(_interleave2(table.x, bx), _interleave2(table.y, table.y),
                    _interleave2(table.z, table.z))


def build_table(p: PointVec) -> PointVec:
    """Multiples table [9, ..., n]: entry d = d*P_i, built in one double
    and two batched adds of widths 2 and 4 (d2; d3, d4; d5..d8)."""
    d = [None, p, double(p)]
    d += _unstack_points(add(_stack_points([d[2], d[2]]),
                             _stack_points([p, d[2]])))
    d += _unstack_points(add(_stack_points([d[4]] * 4),
                             _stack_points(d[1:5])))
    inf = infinity(p.batch_shape, device=p.x.device)
    return _stack_points([inf] + d[1:])


def table_select_windows(table: PointVec, digits: torch.Tensor) -> PointVec:
    """table [9, ..., n], signed digits [..., n, W] -> [..., W, n] points
    (entry |d|, y negated where d < 0)."""
    idx = digits.abs().long()[..., None]                       # [..., n, W, 1]

    def pick(t):                                               # [9, ..., n, 12]
        t = t.movedim(0, -2)                                   # [..., n, 9, 12]
        g = torch.gather(t, -2, idx.expand(idx.shape[:-1] + (fp.NWORDS,)))
        return g.transpose(-3, -2)                             # [..., W, n, 12]

    y = pick(table.y)
    neg_mask = (digits < 0).transpose(-2, -1)                  # [..., W, n]
    return PointVec(pick(table.x), fp.where(neg_mask, fp.neg(y), y),
                    pick(table.z))


def table_select(table: PointVec, neg_y: torch.Tensor, mag: torch.Tensor,
                 neg: torch.Tensor) -> PointVec:
    """One window's select: table [9, ..., n] with its negated y plane,
    digit magnitudes `mag` [..., n] (int64) and signs `neg` [..., n]
    (bool) -> [..., n] contiguous points (entry |d|, -y where d < 0)."""
    idx = mag[None, ..., None].expand((1,) + mag.shape + (fp.NWORDS,))
    pick = lambda t: torch.gather(t, 0, idx)[0]
    return PointVec(pick(table.x),
                    fp.where(neg, pick(neg_y), pick(table.y)),
                    pick(table.z))


def reduce_points_axis(cur: PointVec, chunk: int = 0, *,
                       add: Callable[[PointVec, PointVec], PointVec]
                       ) -> PointVec:
    """Sum [..., m] points over the last batch axis by a halving tree (an
    odd level pads with one infinity) of `add` calls on slices (views).
    chunk > 0 bounds the points per add (slicing along that axis) to bound
    the temporaries."""
    m = cur.x.shape[-2]
    rows = cur.x[..., 0, 0].numel()
    while m > 1:
        half = (m + 1) // 2
        a = pmap(lambda t: t[..., :half, :], cur)
        b = pmap(lambda t: t[..., half:m, :], cur)
        if m & 1:
            pad = infinity(b.batch_shape[:-1] + (1,), device=b.x.device)
            b = PointVec(*(torch.cat([u, v], dim=-2) for u, v in zip(b, pad)))
        step = max(1, chunk // rows) if chunk > 0 else half
        parts = [add(pmap(lambda t: t[..., s:s + step, :], a),
                     pmap(lambda t: t[..., s:s + step, :], b))
                 for s in range(0, half, step)]
        cur = PointVec(*(torch.cat(c, dim=-2) for c in zip(*parts)))
        m = half
    return pmap(lambda t: t[..., 0, :], cur)


def _windowed_combine(sel: PointVec, win_axis: int) -> PointVec:
    """acc = 16*acc + sel_w over the window axis (a batch axis of `sel`)
    through the windowed_combine kernel; returns sel's other batch dims."""
    moved = pmap(lambda t: t.movedim(win_axis, 0), sel)
    batch = moved.x.shape[1:-1]
    flat = pmap(lambda t: t.reshape(t.shape[0], -1, fp.NWORDS).contiguous(),
                moved)
    out = kernels.windowed_combine(flat)
    return pmap(lambda t: t.reshape(batch + (fp.NWORDS,)), out)


def horner(windows: PointVec) -> PointVec:
    """Combine [..., W] window sums MSB-first: acc = 16*acc + S_w."""
    return _windowed_combine(windows, win_axis=-2)


def _halves_add(ext: PointVec) -> PointVec:
    """Fold the interleaved GLV lanes back: out[i] = ext[2i] + ext[2i+1]."""
    return add(pmap(lambda t: t[..., 0::2, :].contiguous(), ext),
               pmap(lambda t: t[..., 1::2, :].contiguous(), ext))


def scalar_mul_device(points: PointVec, digits: torch.Tensor) -> PointVec:
    """out[i] = s_i * P_i over [..., n] (GLV digits [..., 2n, W])."""
    table = extend_table_glv(build_table(points))          # [9, ..., 2n]
    sel = table_select_windows(table, digits)              # [..., W, 2n]
    return _halves_add(_windowed_combine(sel, win_axis=-3))


def scalar_mul_steps(points: PointVec, digits: torch.Tensor) -> PointVec:
    """out[i] = s_i * P_i over [..., n] (GLV digits [..., 2n, W]) as the
    window-at-a-time loop: one `point_x16_add_select` launch a window and
    nothing else. The kernel picks its table entry by that window's digit
    itself and writes the accumulator in place, so the loop gathers,
    selects and allocates nothing, and the [W, 2n] selected points of
    `scalar_mul_device` are never materialised. The device prover uses it
    for its per-point multiplications of a handful of points."""
    table = extend_table_glv(build_table(points))          # [9, ..., 2n]
    digits = digits.contiguous()
    acc = infinity(table.x.shape[1:-1], device=points.x.device)
    for w in range(digits.shape[-1]):
        kernels.point_x16_add_select(acc, table, digits, w, out=acc)
    return _halves_add(acc)


@halflimb.device_cache()
def _rows_index(rows: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """Base-row indices on `device`, uploaded once per tuple and device."""
    return halflimb.upload(rows, torch.long, device)


def msm_rows_windows_from_table(table: PointVec, digits: torch.Tensor,
                                rows: Sequence[int]) -> PointVec:
    """Window sums [m, W] of MSM jobs over rows of an extended table
    [9, k, 2n]; job j uses base row rows[j] and digits[j] [2n, W]."""
    idx = _rows_index(tuple(int(r) for r in rows), table.x.device)
    tab = pmap(lambda t: t.index_select(1, idx).contiguous(), table)
    return kernels.msm_select_reduce(tab, digits.contiguous())


def msm_rows_points_from_table(table: PointVec, digits: torch.Tensor,
                               rows: Sequence[int]) -> PointVec:
    """Per-row MSM jobs straight to their [m] final points on the device:
    the wide phase (`msm_select_reduce` at m jobs), then the Horner tail
    (`windowed_combine` at m rows)."""
    return horner(msm_rows_windows_from_table(table, digits, rows))


# -- device MSM entry points and physical folding -------------------------------

def msm_windows_device(points: PointVec, digits: torch.Tensor) -> PointVec:
    """Wide phase of independent MSMs: points [..., n], GLV digits
    [..., 2n, W] -> window sums [..., W], left on the device. The leading
    dims are flattened to m jobs of one `msm_select_reduce` launch over
    the table [9, m, 2n] of their own bases."""
    batch = tuple(points.batch_shape[:-1])
    n2 = 2 * points.x.shape[-2]
    if tuple(digits.shape[:-1]) != batch + (n2,):
        raise ValueError(f"msm_windows_device: digits {tuple(digits.shape)} "
                         f"do not match points {tuple(points.x.shape)}")
    table = extend_table_glv(build_table(points))          # [9, ..., 2n]
    sums = kernels.msm_select_reduce(
        pmap(lambda t: t.reshape(TABLE_SIZE, -1, n2, fp.NWORDS), table),
        digits.reshape(-1, n2, digits.shape[-1]).contiguous())   # [m, W]
    return pmap(lambda t: t.reshape(batch + t.shape[1:]), sums)


def msm_device(points: PointVec, digits: torch.Tensor) -> PointVec:
    """<s, P> of each leading index of points [..., n] (GLV digits
    [..., 2n, W]) -> [...] points on the device: the wide phase, then one
    Horner launch (`windowed_combine`)."""
    return horner(msm_windows_device(points, digits))


def msm_stacked_device(points: PointVec, digits: torch.Tensor) -> PointVec:
    """MSMs of m jobs over k stacked base rows: points [k, n], GLV digits
    [m, k, 2n, W] -> [m, k] points, out[j, b] = <s_jb, row b>. One table
    for the k rows; the m*k (job, row) pairs are the rows of one
    `msm_select_reduce` launch, then one Horner launch."""
    k, n2 = points.x.shape[0], 2 * points.x.shape[1]
    m = digits.shape[0]
    if tuple(digits.shape[:3]) != (m, k, n2):
        raise ValueError(f"msm_stacked_device: digits {tuple(digits.shape)} "
                         f"do not match bases {tuple(points.x.shape)}")
    table = extend_table_glv(build_table(points))          # [9, k, 2n]
    out = msm_rows_points_from_table(
        table, digits.reshape(m * k, n2, digits.shape[-1]), list(range(k)) * m)
    return pmap(lambda t: t.reshape(m, k, fp.NWORDS), out)


def msm_rows_windows_device(points: PointVec, digits: torch.Tensor,
                            rows: Sequence[int]) -> PointVec:
    """MSM jobs that each take one base row: points [k, n], GLV digits
    [m, 2n, W], rows [m] host ints -> [m, W] window sums on the device."""
    return msm_rows_windows_from_table(extend_table_glv(build_table(points)),
                                       digits, rows)


def msm_rows_device(points: PointVec, digits: torch.Tensor,
                    rows: Sequence[int]) -> PointVec:
    """`msm_rows_windows_device` with the Horner on the device -> [m]."""
    return horner(msm_rows_windows_device(points, digits, rows))


def fold_device(pv: PointVec, digits: torch.Tensor, h: int) -> PointVec:
    """One folding round's base update (innerproductargument.go:155-166 of
    the Go reference) over pv [..., n]:

        out[i] = pv[i] + gamma_i * pv[i + h]   for i < h, infinity for i >= h

    The width n stays. digits [..., 2m, W] (m >= h) are GLV digits whose
    lanes 2i, 2i+1 hold gamma_i; lanes from 2h on are not read (the JAX
    package passes m = n). Only the h products that the fold needs run
    (`scalar_mul_device` on pv[h:2h]), then one add; the lanes from h on
    are set to (0:1:0), not computed. h is a host int."""
    n = pv.x.shape[-2]
    if not 0 <= h <= n // 2 or digits.shape[-2] < 2 * h:
        raise ValueError(f"fold_device: h={h} for width {n} and digits "
                         f"{tuple(digits.shape)}")
    pad = infinity(tuple(pv.batch_shape[:-1]) + (n - h,), device=pv.x.device)
    if h == 0:
        return pad
    lo = pmap(lambda t: t[..., :h, :].contiguous(), pv)
    hi = pmap(lambda t: t[..., h:2 * h, :].contiguous(), pv)
    folded = add(lo, scalar_mul_device(hi, digits[..., :2 * h, :]))
    return PointVec(*(torch.cat([a, b], dim=-2) for a, b in zip(folded, pad)))


def _gamma_digits(gammas: Sequence[int], h: int,
                  device: torch.device) -> torch.Tensor:
    """[k] gammas -> [k, 2h, W] GLV digits: the k gammas recoded in one
    launch, each [2, W] repeated over the h lanes on the device."""
    one = recode([([g], 0, 1) for g in gammas], device, bases=False)
    return one.reshape(len(gammas), 1, 2, NUM_WINDOWS).expand(
        -1, h, -1, -1).reshape(len(gammas), 2 * h, NUM_WINDOWS)


# -- host-facing APIs ------------------------------------------------------------

def _pad_pow2(n: int, minimum: int = 8) -> int:
    m = minimum
    while m < n:
        m *= 2
    return m


MsmTerm = Tuple[int, Sequence[int], int]      # (base row, scalars, offset)
Base = Union[Affine, int]        # a host point, or a row of device points


class StackedVec:
    """k base rows [k, n] on a device, with their GLV-extended multiples
    table [9, k, 2n] built once on first use. The folding arguments (IPA:
    [Gs, Gs']; same-multiscalar: [G, T, U]) keep their bases stacked so a
    round's cross-term MSMs are one `msm_many` call."""

    def __init__(self, pv: PointVec, n_valid: Optional[int] = None):
        self.pv = pv
        self.k = pv.x.shape[0]
        self.width = pv.x.shape[1]
        self.n_valid = self.width if n_valid is None else n_valid
        self._table = None

    def table(self) -> PointVec:
        if self._table is None:
            self._table = extend_table_glv(build_table(self.pv))
        return self._table

    @classmethod
    def from_affine(cls, vecs: Sequence[Sequence[Affine]], *,
                    device: torch.device, pad_to: int = 0) -> "StackedVec":
        """pad_to: exact width when >= the widest row, else the next power
        of two; rows pad with infinity."""
        widest = max(len(v) for v in vecs)
        n = pad_to if pad_to >= widest else _pad_pow2(widest)
        flat = []
        for v in vecs:
            flat.extend(list(v) + [None] * (n - len(v)))
        return cls(pmap(lambda t: t.reshape(len(vecs), n, fp.NWORDS),
                        from_affine_host(flat, device=device)), widest)

    @profiling.traced("msm")
    def msm_many(self, jobs: Sequence[Sequence[MsmTerm]]) -> List[Affine]:
        """jobs[j] = [(base_row, scalars, offset), ...] summed into output
        j: out[j] = sum_i <scalars_i, row b_i[off_i : off_i + len]>. Every
        term is one MSM job over its base row: ONE wide-phase launch over
        all terms, ONE Horner launch, ONE fetch, then the host adds each
        term's point to its owner."""
        scalar_rows, rows_idx, owners = [], [], []
        for j, terms in enumerate(jobs):
            for (row, scalars, offset) in terms:
                if offset < 0 or offset + len(scalars) > self.width:
                    raise ValueError("msm_many: scalars run past the row")
                scalar_rows.append((scalars, offset, self.width))
                rows_idx.append(row)
                owners.append(j)
        res: List[Affine] = [None] * len(jobs)
        if not owners:
            return res
        digits = recode(scalar_rows, self.pv.x.device).reshape(
            len(owners), 2 * self.width, NUM_WINDOWS)
        out = msm_rows_points_from_table(self.table(), digits, rows_idx)
        for j, pt in zip(owners, to_affine_host(out)):
            res[j] = fh.g1_add(res[j], pt)
        return res

    def fold(self, gammas) -> "StackedVec":
        """Fold every base row on the device: row'[i] = row[i] + gamma_row *
        row[i + h] for i < h = n_valid // 2 (an odd n_valid drops its last
        lane), infinity beyond; `gammas` is one scalar or one per row. The
        folded StackedVec builds its own table when one is asked for."""
        if not isinstance(gammas, (list, tuple)):
            gammas = [gammas] * self.k
        if len(gammas) != self.k:
            raise ValueError(f"fold: {len(gammas)} gammas for {self.k} rows")
        with profiling.span("fold"):
            h = self.n_valid // 2
            digits = _gamma_digits(gammas, h, self.pv.x.device)
            return StackedVec(fold_device(self.pv, digits, h), h)


class FoldedBases:
    """Lazy folding view over a StackedVec: folds and per-lane rescales are
    scalar-side transforms, not device base updates.

    The folding arguments update bases G' = G_lo + gamma*G_hi every round
    (innerproductargument.go:155-166, samemultiscalarargument.go:85-140 of
    the Go reference). Since <v, G'> = <v ++ gamma*v, G>, the prover keeps
    the ORIGINAL bases on the device (the multiples table is built once
    per argument) and pushes every fold into the scalars (O(n) host Fr
    products per round), with byte-identical proofs.

    A logical row maps to a base row plus an optional per-lane diagonal
    multiplier d (row = d[i]*base[i]): <v, d.base> = <v*d, base>. The
    grand-product argument uses this for its rescaled bases
    Gs' = Gs*beta^-i (grandproductargument.go:94-103): no device rescale.
    """

    def __init__(self, sv: StackedVec, rows: Optional[Sequence[int]] = None,
                 diags: Optional[Dict[int, Sequence[int]]] = None,
                 gammas: Optional[List[List[int]]] = None,
                 n_valid: Optional[int] = None):
        self.sv = sv
        self.rows = list(rows) if rows is not None else list(range(sv.k))
        self.k = len(self.rows)
        self.width = sv.width
        self.diags = diags or {}          # logical row -> per-lane multiplier
        self.gammas = gammas or []        # per round: one gamma per logical row
        self.n_valid = sv.n_valid if n_valid is None else n_valid

    @classmethod
    def from_affine(cls, vecs: Sequence[Sequence[Affine]], *,
                    device: torch.device, pad_to: int = 0) -> "FoldedBases":
        return cls(StackedVec.from_affine(vecs, device=device, pad_to=pad_to))

    def fold(self, gammas) -> "FoldedBases":
        """Record a fold out[i] = in[i] + gamma_row * in[i + n/2]; no device
        work. `gammas` is one scalar or one per logical row."""
        if not isinstance(gammas, (list, tuple)):
            gammas = [gammas] * self.k
        return FoldedBases(self.sv, self.rows, self.diags,
                           self.gammas + [list(gammas)], self.n_valid // 2)

    def _expand(self, row: int, scalars: Sequence[int],
                offset: int) -> List[int]:
        """Lift (scalars at offset, current fold level) to level-0 scalars."""
        u = [0] * self.n_valid
        for i, s in enumerate(scalars):
            u[offset + i] = int(s) % fh.R
        for per_row in reversed(self.gammas):
            g = per_row[row]
            u = u + [s * g % fh.R for s in u]
        d = self.diags.get(row)
        if d is not None:
            u = [s * di % fh.R if di is not None else s
                 for s, di in zip(u, list(d) + [1] * (len(u) - len(d)))]
        return u

    def msm_many(self, jobs: Sequence[Sequence[MsmTerm]]) -> List[Affine]:
        with profiling.span("expand"):
            jobs = [[(self.rows[r], self._expand(r, sc, off), 0)
                     for (r, sc, off) in terms] for terms in jobs]
        return self.sv.msm_many(jobs)


class DeviceVec:
    """A fixed-width vector of G1 points on a device ([width], padded with
    infinity), folded in place of the bases of a folding argument: the
    bases stay on the device across the rounds, only single points come
    back to the host."""

    def __init__(self, pv: PointVec, n_valid: int):
        self.pv = pv
        self.n_valid = n_valid
        self.width = pv.x.shape[0]

    @classmethod
    def from_affine(cls, pts: Sequence[Affine], *, device: torch.device,
                    pad_to: int = 0) -> "DeviceVec":
        """Width: the next power of two from max(len(pts), pad_to), at
        least 8."""
        n = _pad_pow2(max(len(pts), pad_to))
        return cls(from_affine_host(list(pts) + [None] * (n - len(pts)),
                                    device=device), len(pts))

    @profiling.traced("msm")
    def msm(self, scalars: Sequence[int], offset: int = 0) -> Affine:
        """<scalars, self[offset : offset + len(scalars)]>: the window sums
        and their Horner combination on the device (`msm_device`), one
        fetch of one point."""
        if offset < 0 or offset + len(scalars) > self.width:
            raise ValueError("DeviceVec.msm: scalars run past the vector")
        digits = recode([(scalars, offset, self.width)], self.pv.x.device)
        return to_affine_host_single(msm_device(self.pv, digits))

    def fold(self, gamma: int) -> "DeviceVec":
        """self'[i] = self[i] + gamma * self[i + h], h = n_valid // 2."""
        h = self.n_valid // 2
        digits = _gamma_digits([gamma], h, self.pv.x.device)[0]
        return DeviceVec(fold_device(self.pv, digits, h), h)

    def to_affine(self) -> List[Affine]:
        return to_affine_host(self.pv)[: self.n_valid]


def msm_batch(jobs: Sequence[Tuple[Sequence[Affine], Sequence[int]]], *,
              device: torch.device) -> List[Affine]:
    """Independent small MSMs in one device call and one fetch:
    jobs[j] = (points_j, scalars_j), every job padded to a common width."""
    jobs = [(list(p), list(sc)) for p, sc in jobs]
    if not jobs:
        return []
    for p, sc in jobs:
        if len(p) != len(sc):
            raise ValueError("msm_batch: len(points) != len(scalars)")
    width = _pad_pow2(max(len(p) for p, _ in jobs))
    sv = StackedVec.from_affine([p for p, _ in jobs], device=device,
                                pad_to=width)
    return sv.msm_many([[(j, sc, 0)] for j, (_, sc) in enumerate(jobs)])


# An MSM over more than _ROWS_ABOVE fresh bases runs as rows of _ROW_POINTS
# bases of one table (batched verification reaches ~17k bases): one padded
# row of a power of two would take up to twice the lanes and the memory.
_ROWS_ABOVE = 8192
_ROW_POINTS = 4096


def _dynamic_layout(n: int) -> Tuple[int, int]:
    """(rows, bases a row) of the fresh table of an n-base MSM."""
    if n <= _ROWS_ABOVE:
        return 1, _pad_pow2(n)
    return -(-n // _ROW_POINTS), _ROW_POINTS


def _sum_rows(sums: PointVec) -> PointVec:
    """[k, ...] points -> [1, ...]: a halving tree of adds over the first
    axis (its slices stay contiguous)."""
    while sums.x.shape[0] > 1:
        k = sums.x.shape[0]
        h = k // 2
        s = add(pmap(lambda t: t[:h], sums), pmap(lambda t: t[h:2 * h], sums))
        if k % 2:
            s = PointVec(*(torch.cat([u, t[2 * h:]]) for u, t in zip(s, sums)))
        sums = s
    return sums


def _dynamic_rows(scalars: Sequence[int], n: int) -> List[ScalarRow]:
    """The scalar rows of an n-base MSM's fresh table (`_dynamic_layout`)."""
    k, w = _dynamic_layout(n)
    sc = list(scalars)
    return [(sc[i * w:(i + 1) * w], 0, w) for i in range(k)]


def _dynamic_bases(points: Sequence[Base], resident: Optional[torch.Tensor],
                   device: torch.device) -> PointVec:
    """The [k, w] bases of an n-base MSM's fresh table (`_dynamic_layout`),
    infinity in the pad lanes. An int in `points` is a row of `resident`
    ([3, m, 12] planes of points already on the device: a decode's,
    `codec_batch.Decoded.pts`), gathered there; only the host's Affine
    points are converted and uploaded (`affine_planes`). Counters
    `msm.resident` and `msm.uploaded` count the two kinds."""
    k, w = _dynamic_layout(len(points))
    m = 0 if resident is None else resident.shape[1]
    host, idx = [], []           # host point i is row m + i, then one pad
    for p in points:
        if not isinstance(p, int):
            idx.append(m + len(host))
            host.append(p)
        elif 0 <= p < m:
            idx.append(p)
        else:
            raise ValueError(f"resident row {p} outside [0, {m})")
    idx += [m + len(host)] * (k * w - len(points))
    profiling.count("msm.resident", len(points) - len(host))
    profiling.count("msm.uploaded", len(host))
    planes = affine_planes(host + [None], device=device)
    if m:
        planes = torch.cat([resident, planes], dim=1)
    planes = planes.index_select(1, halflimb.upload(idx, torch.long, device))
    return PointVec(*(t.view(k, w, fp.NWORDS) for t in planes))


def _dynamic_sums(bases: PointVec, digits: torch.Tensor) -> PointVec:
    """[1, W] window sums of [k, w] bases (`_dynamic_bases`) over a fresh
    table, their digits recoded from `_dynamic_rows`: each row's sums in
    one wide-phase launch, added pointwise."""
    sv = StackedVec(bases)
    return _sum_rows(msm_rows_windows_from_table(
        sv.table(), digits.reshape(sv.k, 2 * sv.width, NUM_WINDOWS),
        list(range(sv.k))))


def _dynamic_windows(points: Sequence[Base], scalars: Sequence[int],
                     device: torch.device,
                     resident: Optional[torch.Tensor] = None) -> PointVec:
    """[1, W] window sums of <scalars, points> over a fresh table."""
    digits = recode(_dynamic_rows(scalars, len(points)), device)
    return _dynamic_sums(_dynamic_bases(points, resident, device), digits)


@profiling.traced("msm")
def msm(points: Sequence[Base], scalars: Sequence[int], *,
        device: torch.device,
        resident: Optional[torch.Tensor] = None) -> Affine:
    """<scalars, points> (scalars taken mod r). A point is a host Affine or
    an int, a row of the device points `resident` (`_dynamic_bases`)."""
    if len(points) != len(scalars):
        raise ValueError("msm: len(points) != len(scalars)")
    if not points:
        return None
    return to_affine_host(horner(_dynamic_windows(points, scalars, device,
                                                  resident)))[0]


@profiling.traced("msm")
def msm_with_static(static_sv: StackedVec, static_scalars: Sequence[int],
                    points: Sequence[Base], scalars: Sequence[int], *,
                    resident: Optional[torch.Tensor] = None) -> Affine:
    """<static_scalars, static_sv row 0> + <scalars, points>: the static
    row's window sums off its cached table, the dynamic points' off a fresh
    one, added pointwise, one Horner, one fetch. The static row's scalars
    and the dynamic ones are recoded in one launch. A dynamic point is a
    host Affine or an int, a row of the device points `resident`
    (`_dynamic_bases`)."""
    if len(points) != len(scalars):
        raise ValueError("msm_with_static: len(points) != len(scalars)")
    device = static_sv.pv.x.device
    n2 = 2 * static_sv.width
    dyn = _dynamic_rows(scalars, len(points)) if points else []
    digits = recode([(static_scalars, 0, static_sv.width)] + dyn, device)
    acc = msm_rows_windows_from_table(
        static_sv.table(), digits[:n2].reshape(1, n2, NUM_WINDOWS), [0])
    if points:
        acc = add(acc, _dynamic_sums(
            _dynamic_bases(points, resident, device), digits[n2:]))
    return to_affine_host(horner(acc))[0]


@profiling.traced("msm")
def batch_scalar_mul(points: Sequence[Affine], scalars: Sequence[int], *,
                     device: torch.device) -> List[Affine]:
    """[s_i * P_i] in one batched scalar multiplication."""
    if len(points) != len(scalars):
        raise ValueError("batch_scalar_mul: length mismatch")
    if not points:
        return []
    n = _pad_pow2(len(points))
    pv = from_affine_host(list(points) + [None] * (n - len(points)),
                          device=device)
    out = scalar_mul_device(pv, recode([(scalars, 0, n)], device))
    return to_affine_host_xy(out)[: len(points)]
