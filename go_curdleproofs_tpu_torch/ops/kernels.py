"""The port's device kernels: wrappers, plain versions, counters.

Each kernel (CUDA C++ for sm_90a; ops/csrc/pointwise.cu holds mont_mul,
point_add, point_double, fr_mont_mul and fr_pow_fixed, ops/csrc/kernels.cu
holds pow_fixed, windowed_combine, msm_select_reduce, point_x16_add and
decode_points;
mont_mul runs on the team product of ops/csrc/fp_team.cuh;
point_add, point_double and the last four run on the cooperative point
operations of ops/csrc/point_coop.cuh; ops/csrc/transcript.cu holds
strobe_absorb_stream and strobe_challenge32; the Fp and Fr arithmetic of
all of them is ops/csrc/fp_asm.cuh and fr_asm.cuh, written by
ops/csrc/gen_fp_asm.py) has

  * a wrapper that checks its tensors and, for CUDA tensors, launches the
    kernel on PyTorch's current stream, raising if the launch is refused;
    for CPU tensors it runs the plain version instead. There is no other
    route: a CUDA tensor never falls back to the plain version;
  * a plain version in torch integer ops, exact, on any device: the CPU path,
    and the reference that the kernel is held against on the card. A plain
    version calls only plain versions (`fp.mul_plain`, `point_add_plain`,
    ...), never a wrapper, so on the card it stays independent of every
    kernel;
  * a launch counter (`launches`), incremented where the kernel launches.

The CUDA sources build with nvcc, one process per .cu file started
together, into `go_curdleproofs_tpu_torch/_build/libcurdle_<file>.so` at
first use, again whenever the sources' hash changes, and load with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import torch

from ..utils.field_host import B_COEFF, P
from ..utils.field_host import R as FR_MODULUS
from . import curve, fp, fr, glv, halflimb, keccak_dev

_CSRC = Path(__file__).resolve().parent / "csrc"
_CU_SOURCES = ("kernels.cu", "pointwise.cu", "transcript.cu")  # a library each
_SOURCES = ("fp.cuh", "fp_asm.cuh", "fp_team.cuh", "fr.cuh", "fr_asm.cuh",
            "point_coop.cuh") + _CU_SOURCES
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the .cu file that holds each kernel
KERNEL_SOURCE = {"mont_mul": "pointwise.cu", "point_add": "pointwise.cu",
                 "point_double": "pointwise.cu", "pow_fixed": "kernels.cu",
                 "windowed_combine": "kernels.cu",
                 "msm_select_reduce": "kernels.cu",
                 "point_x16_add": "kernels.cu",
                 "decode_points": "kernels.cu",
                 "fr_pow_fixed": "pointwise.cu",
                 "fr_mont_mul": "pointwise.cu",
                 "strobe_absorb_stream": "transcript.cu",
                 "strobe_challenge32": "transcript.cu"}
KERNEL_NAMES = tuple(KERNEL_SOURCE)
launches: Dict[str, int] = {name: 0 for name in KERNEL_NAMES}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# -- build and load -----------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()


def _sources_hash() -> str:
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _lib_path(cu: str) -> Path:
    return BUILD_DIR / f"libcurdle_{Path(cu).stem}.so"


def build(force: bool = False) -> Dict[str, Path]:
    """Compile each .cu source into its own library in BUILD_DIR, all nvcc
    processes running together, unless a build of the current sources is
    already there. Returns {source: library path}; the compiler's reports
    (registers, spills per kernel) go to BUILD_DIR/nvcc.log."""
    libs = {cu: _lib_path(cu) for cu in _CU_SOURCES}
    stamp = BUILD_DIR / "kernels.sha256"
    digest = _sources_hash()
    if (not force and stamp.exists() and stamp.read_text() == digest
            and all(lib.exists() for lib in libs.values())):
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for cu, lib in libs.items():
        tmp = BUILD_DIR / f"{lib.name}.{os.getpid()}.tmp"
        log = BUILD_DIR / f"nvcc.{Path(cu).stem}.log"
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / cu)],
                stdout=out, stderr=subprocess.STDOUT)
        jobs.append((cu, lib, tmp, log, proc))
    codes = {cu: proc.wait() for cu, _, _, _, proc in jobs}
    report = "".join(f"== {cu}\n{log.read_text()}"
                     for cu, _, _, log, _ in jobs)
    (BUILD_DIR / "nvcc.log").write_text(report)
    if any(codes.values()):
        raise RuntimeError(f"nvcc failed ({codes}):\n{report}")
    for _, lib, tmp, _, _ in jobs:
        os.replace(tmp, lib)
    stamp.write_text(digest)
    return libs


def _load() -> SimpleNamespace:
    """The launchers of all libraries, with their argument types."""
    global _lib
    with _lib_lock:
        if _lib is None:
            paths = build()
            main = ctypes.CDLL(str(paths["kernels.cu"]))
            pointwise = ctypes.CDLL(str(paths["pointwise.cu"]))
            transcript = ctypes.CDLL(str(paths["transcript.cu"]))
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fns = SimpleNamespace(
                point_x16_add=main.curdle_point_x16_add,
                point_x16_add_select=main.curdle_point_x16_add_select,
                fr_mont_mul=pointwise.curdle_fr_mont_mul,
                fr_pow_fixed=pointwise.curdle_fr_pow_fixed,
                strobe_absorb_stream=transcript.curdle_strobe_absorb_stream,
                strobe_challenge32=transcript.curdle_strobe_challenge32,
                pow_fixed=main.curdle_pow_fixed,
                windowed_combine=main.curdle_windowed_combine,
                msm_select_reduce=main.curdle_msm_select_reduce,
                mont_mul=pointwise.curdle_mont_mul,
                point_add=pointwise.curdle_point_add,
                point_double=pointwise.curdle_point_double,
                decode_points=main.curdle_decode_points)
            fns.pow_fixed.argtypes = [
                vp, vp, i32, ctypes.POINTER(ctypes.c_uint32), i32, i32, vp]
            fns.windowed_combine.argtypes = [vp] * 6 + [i32, i32, vp]
            fns.msm_select_reduce.argtypes = [vp] * 10 + [i32] * 4 + [vp]
            fns.mont_mul.argtypes = [vp, vp, vp, i64, i32, i32, vp]
            fns.point_add.argtypes = [vp] * 9 + [i64, vp]
            fns.point_double.argtypes = [vp] * 6 + [i64, vp]
            fns.point_x16_add.argtypes = [vp] * 9 + [i32, vp]
            fns.point_x16_add_select.argtypes = [vp] * 10 + [i32] * 3 + [vp]
            fns.decode_points.argtypes = [vp, vp, vp, i32, vp]
            fns.fr_mont_mul.argtypes = [vp, vp, vp, i64, i32, i32, vp]
            fns.fr_pow_fixed.argtypes = [
                vp, vp, i64, ctypes.POINTER(ctypes.c_uint32), i32, vp]
            fns.strobe_absorb_stream.argtypes = [
                vp, vp, vp, i32, i32, vp, i32, i32, vp]
            fns.strobe_challenge32.argtypes = [
                vp, vp, vp, ctypes.c_char_p, vp, i32, i32, i32, vp]
            for fn in vars(fns).values():
                fn.restype = i32
            _lib = fns
        return _lib


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _route(*tensors: torch.Tensor, dtype: torch.dtype = torch.int32) -> str:
    """'cpu' (plain version) or 'cuda' (kernel), after checking that every
    tensor is of `dtype`, contiguous and on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"kernel input must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel input must be contiguous")
        if t.device != dev:
            raise ValueError("kernel inputs lie on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel route for device {dev}")
    return dev.type


def _check_elems(t: torch.Tensor, ndim: int, name: str) -> None:
    if t.ndim != ndim or t.shape[-1] != fp.NWORDS:
        raise ValueError(f"{name}: expected {ndim} dims ending in "
                         f"{fp.NWORDS} words, got {tuple(t.shape)}")


# -- B1: batched Fp multiply ---------------------------------------------------

mont_mul_plain = fp.mul_plain


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b / R mod p elementwise over [..., 12] elements. The operands
    have one shape, or either is a single [12] element that multiplies the
    whole batch (read in place by the kernel, never materialised)."""
    for t in (a, b):
        if t.ndim < 1 or t.shape[-1] != fp.NWORDS:
            raise ValueError(f"mont_mul: bad element shape {tuple(t.shape)}")
    if a.shape != b.shape and a.ndim != 1 and b.ndim != 1:
        raise ValueError(f"mont_mul: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ and neither is one element")
    if _route(a, b) == "cpu":
        return mont_mul_plain(a, b)
    shape = a.shape if a.ndim >= b.ndim else b.shape
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    lib = _load()
    with torch.cuda.device(a.device):
        rc = lib.mont_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                          out.numel() // fp.NWORDS,
                          int(a.shape == shape), int(b.shape == shape),
                          _stream(a.device))
    _check(rc, "mont_mul")
    launches["mont_mul"] += 1
    return out


# -- B2, B3: complete point add and double -------------------------------------

def _mul_stacked_plain(avec, bvec):
    """Independent products as ONE stacked plain field multiply."""
    return list(fp.mul_plain(torch.stack(avec), torch.stack(bvec)).unbind(0))


def point_add_plain(p: curve.PointVec, q: curve.PointVec) -> curve.PointVec:
    """Complete projective addition (RCB16 algorithm 7, a = 0), two-stage,
    in plain field ops (shapes broadcast)."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    t0, t1, t2, m4, m5, m6 = _mul_stacked_plain(
        [x1, y1, z1, fp.add(x1, y1), fp.add(y1, z1), fp.add(x1, z1)],
        [x2, y2, z2, fp.add(x2, y2), fp.add(y2, z2), fp.add(x2, z2)])
    t3 = fp.sub(m4, fp.add(t0, t1))
    t4 = fp.sub(m5, fp.add(t1, t2))
    y3 = fp.sub(m6, fp.add(t0, t2))
    t0_3 = fp.add(fp.add(t0, t0), t0)
    t2b = fp.mul_small_plain(t2, curve.B3)
    z3 = fp.add(t1, t2b)
    t1m = fp.sub(t1, t2b)
    y3b = fp.mul_small_plain(y3, curve.B3)
    n1, n2, n3, n4, n5, n6 = _mul_stacked_plain(
        [t4, t3, y3b, t1m, t0_3, z3],
        [y3b, t1m, t0_3, z3, t3, t4])
    return curve.PointVec(fp.sub(n2, n1), fp.add(n4, n3), fp.add(n6, n5))


def point_double_plain(p: curve.PointVec) -> curve.PointVec:
    """Complete projective doubling (RCB16 algorithm 9, a = 0), two-stage,
    in plain field ops."""
    x, y, z = p
    t0, t1, t2r, m4 = _mul_stacked_plain([y, y, z, x], [y, z, z, y])
    t2 = fp.mul_small_plain(t2r, curve.B3)
    t00 = fp.add(t0, t0)
    t04 = fp.add(t00, t00)
    z3s = fp.add(t04, t04)                               # 8*t0
    y3s = fp.add(t0, t2)
    t0m = fp.sub(t0, fp.add(fp.add(t2, t2), t2))        # t0 - 3*t2
    n1, n2, n3, n4 = _mul_stacked_plain([t2, t0m, t1, t0m],
                                        [z3s, y3s, z3s, m4])
    return curve.PointVec(fp.add(n4, n4), fp.add(n1, n2), n3)


def _check_points(name: str, *points: curve.PointVec) -> None:
    shape = points[0].x.shape
    if len(shape) < 1 or shape[-1] != fp.NWORDS:
        raise ValueError(f"{name}: bad element shape {tuple(shape)}")
    for pt in points:
        for t in pt:
            if t.shape != shape:
                raise ValueError(f"{name}: coordinate shapes differ: "
                                 f"{tuple(t.shape)} vs {tuple(shape)}")


def _empty_points(like: torch.Tensor) -> curve.PointVec:
    return curve.PointVec(*(torch.empty_like(like) for _ in range(3)))


def point_add(p: curve.PointVec, q: curve.PointVec) -> curve.PointVec:
    """P + Q pointwise over [..., 12]-coordinate batches of one shape,
    complete: infinity, P + P and P + (-P) need no special case. p and q
    may be the same tensors; the result is always fresh tensors."""
    _check_points("point_add", p, q)
    if _route(*p, *q) == "cpu":
        return point_add_plain(p, q)
    out = _empty_points(p.x)
    lib = _load()
    with torch.cuda.device(p.x.device):
        rc = lib.point_add(*(t.data_ptr() for t in p),
                           *(t.data_ptr() for t in q),
                           *(t.data_ptr() for t in out),
                           p.x.numel() // fp.NWORDS, _stream(p.x.device))
    _check(rc, "point_add")
    launches["point_add"] += 1
    return out


def point_double(p: curve.PointVec) -> curve.PointVec:
    """2 * P pointwise over a [..., 12]-coordinate batch, complete."""
    _check_points("point_double", p)
    if _route(*p) == "cpu":
        return point_double_plain(p)
    out = _empty_points(p.x)
    lib = _load()
    with torch.cuda.device(p.x.device):
        rc = lib.point_double(*(t.data_ptr() for t in p),
                              *(t.data_ptr() for t in out),
                              p.x.numel() // fp.NWORDS, _stream(p.x.device))
    _check(rc, "point_double")
    launches["point_double"] += 1
    return out


# -- B7: fixed-exponent ladder ------------------------------------------------

pow_fixed_plain = fp.pow_fixed_plain


_POW_THREADS = 32           # one warp a block: pow_fixed_kernel's note


def pow_fixed(x: torch.Tensor, exponent: int,
              _threads: Optional[int] = None) -> torch.Tensor:
    """x^exponent elementwise over [..., 12] elements (exponent >= 1).
    `_threads` (timing scripts only) overrides the threads a block."""
    if exponent < 1 or exponent.bit_length() > 32 * fp.NWORDS:
        raise ValueError("pow_fixed exponent must lie in [1, 2^384)")
    if x.shape[-1] != fp.NWORDS:
        raise ValueError(f"pow_fixed: bad element shape {tuple(x.shape)}")
    threads = _POW_THREADS if _threads is None else _threads
    if threads not in (32, 64, 128):
        raise ValueError(f"pow_fixed: {threads} threads a block")
    if _route(x) == "cpu":
        return pow_fixed_plain(x, exponent)
    out = torch.empty_like(x)
    words = (ctypes.c_uint32 * fp.NWORDS)(
        *[(exponent >> (32 * j)) & 0xFFFFFFFF for j in range(fp.NWORDS)])
    lib = _load()
    with torch.cuda.device(x.device):
        rc = lib.pow_fixed(
            x.data_ptr(), out.data_ptr(), x.numel() // fp.NWORDS, words,
            exponent.bit_length(), threads, _stream(x.device))
    _check(rc, "pow_fixed")
    launches["pow_fixed"] += 1
    return out


# -- B5: Horner over windows --------------------------------------------------

def windowed_combine_plain(sel: curve.PointVec) -> curve.PointVec:
    n_win = sel.x.shape[0]
    acc = curve.infinity(sel.x.shape[1:-1], device=sel.x.device)
    for w in range(n_win):
        for _ in range(curve.WINDOW_BITS):
            acc = point_double_plain(acc)
        acc = point_add_plain(acc, curve.pmap(lambda t, w=w: t[w], sel))
    return acc


def windowed_combine(sel: curve.PointVec) -> curve.PointVec:
    """sel: [W, rows, 12] per coordinate, MSB window first ->
    [rows, 12] per coordinate: acc = 16*acc + sel[w] over w."""
    for t in sel:
        _check_elems(t, 3, "windowed_combine")
        if t.shape != sel.x.shape:
            raise ValueError("windowed_combine: coordinate shapes differ")
    if _route(*sel) == "cpu":
        return windowed_combine_plain(sel)
    n_win, rows = sel.x.shape[0], sel.x.shape[1]
    out = curve.PointVec(*(torch.empty((rows, fp.NWORDS), dtype=torch.int32,
                                       device=sel.x.device) for _ in range(3)))
    lib = _load()
    with torch.cuda.device(sel.x.device):
        rc = lib.windowed_combine(
            *(t.data_ptr() for t in sel), *(t.data_ptr() for t in out),
            n_win, rows, _stream(sel.x.device))
    _check(rc, "windowed_combine")
    launches["windowed_combine"] += 1
    return out


# -- B6: MSM wide phase --------------------------------------------------------

_REDUCE_CHUNK = 2048        # points per plain tree-level add (bounds temporaries)


def msm_select_reduce_plain(table: curve.PointVec,
                            digits: torch.Tensor) -> curve.PointVec:
    sel = curve.table_select_windows(table, digits)      # [m, W, n2]
    return curve.reduce_points_axis(sel, chunk=_REDUCE_CHUNK,
                                    add=point_add_plain)


# How the lanes of one (window, job) are split over blocks. One lane's
# product keeps the integer pipe of its SM quarter more than half busy, so
# a second block on an SM slows both: measured on an H100, the kernel is
# fastest with as many blocks as fit one to an SM (132), down to 64 lanes
# (two per group) a block; the finishing launch sums at most 16 partial sums.
_SM_COUNT = 132
_SPLIT_MIN_LANES = 64
_SPLIT_MAX = 16


def _msm_split(m: int, n2: int, n_windows: int) -> int:
    """Blocks that share the lanes of one (window, job): as many as keep
    n_windows * m * split within one block an SM, while a block keeps at
    least _SPLIT_MIN_LANES lanes. 1 from three jobs on at 33 windows."""
    fill = _SM_COUNT // max(1, n_windows * m)
    return max(1, min(fill, n2 // _SPLIT_MIN_LANES, _SPLIT_MAX))


def msm_select_reduce(table: curve.PointVec, digits: torch.Tensor,
                      _split: Optional[int] = None) -> curve.PointVec:
    """table: [9, m, n2, 12] per coordinate (entry d = d*P_l); digits:
    [m, n2, W] int32 signed window digits in [-8, 8], MSB window first ->
    window sums [m, W, 12] per coordinate. `_split` (tests only) overrides
    the number of blocks that share one job's lanes."""
    for t in table:
        _check_elems(t, 4, "msm_select_reduce")
        if t.shape != table.x.shape:
            raise ValueError("msm_select_reduce: coordinate shapes differ")
    n_tab, m, n2 = table.x.shape[:3]
    if n_tab != curve.TABLE_SIZE:
        raise ValueError(f"msm_select_reduce: table has {n_tab} entries, "
                         f"expected {curve.TABLE_SIZE}")
    if digits.ndim != 3 or tuple(digits.shape[:2]) != (m, n2):
        raise ValueError(f"msm_select_reduce: digits {tuple(digits.shape)} "
                         f"do not match table [{m}, {n2}]")
    n_win = digits.shape[2]
    split = _msm_split(m, n2, n_win) if _split is None else _split
    if not 1 <= split <= _SPLIT_MAX:
        raise ValueError(f"msm_select_reduce: split {split} outside "
                         f"[1, {_SPLIT_MAX}]")
    if _route(*table, digits) == "cpu":
        return msm_select_reduce_plain(table, digits)
    out = curve.PointVec(*(torch.empty((m, n_win, fp.NWORDS),
                                       dtype=torch.int32,
                                       device=digits.device)
                           for _ in range(3)))
    # partial sums [3, split, m, W, 12] between the two launches of a split
    scratch = None if split == 1 else torch.empty(
        (3, split, m, n_win, fp.NWORDS), dtype=torch.int32,
        device=digits.device)
    part = (None,) * 3 if scratch is None else tuple(
        t.data_ptr() for t in scratch.unbind(0))
    lib = _load()
    with torch.cuda.device(digits.device):
        rc = lib.msm_select_reduce(
            *(t.data_ptr() for t in table), digits.data_ptr(),
            *(t.data_ptr() for t in out), *part, m, n2, n_win, split,
            _stream(digits.device))
    _check(rc, "msm_select_reduce")
    launches["msm_select_reduce"] += 1
    return out


# -- B4: the fused 16*acc + sel step -------------------------------------------

def point_x16_add_plain(acc: curve.PointVec,
                        sel: curve.PointVec) -> curve.PointVec:
    for _ in range(curve.WINDOW_BITS):
        acc = point_double_plain(acc)
    return point_add_plain(acc, sel)


def point_x16_add(acc: curve.PointVec, sel: curve.PointVec) -> curve.PointVec:
    """16 * acc + sel pointwise over [..., 12]-coordinate batches of one
    shape: four complete doublings and one complete add in one launch.
    The result is always fresh tensors."""
    _check_points("point_x16_add", acc, sel)
    if _route(*acc, *sel) == "cpu":
        return point_x16_add_plain(acc, sel)
    out = _empty_points(acc.x)
    lib = _load()
    with torch.cuda.device(acc.x.device):
        rc = lib.point_x16_add(*(t.data_ptr() for t in acc),
                               *(t.data_ptr() for t in sel),
                               *(t.data_ptr() for t in out),
                               acc.x.numel() // fp.NWORDS,
                               _stream(acc.x.device))
    _check(rc, "point_x16_add")
    launches["point_x16_add"] += 1
    return out


def point_x16_add_select_plain(acc: curve.PointVec, table: curve.PointVec,
                               digits: torch.Tensor, w: int) -> curve.PointVec:
    d = digits[..., w]
    sel = curve.table_select(table, fp.neg(table.y), d.abs().long(), d < 0)
    return point_x16_add_plain(acc, sel)


def point_x16_add_select(acc: curve.PointVec, table: curve.PointVec,
                         digits: torch.Tensor, w: int,
                         out: Optional[curve.PointVec] = None
                         ) -> curve.PointVec:
    """16 * acc + (entry |d| of the table, negated where d < 0) with
    d = digits[..., w]: the step of `point_x16_add` with the operand
    selected inside the same kernel. acc: [..., 12] per coordinate; table:
    [9, ..., 12] per coordinate (entry k = k times the point, entry 0
    infinity); digits: [..., W] int32 signed window digits in [-8, 8].
    The result goes into `out` when given (three tensors like acc's, which
    may be acc's own: the kernel reads a point whole before it writes it),
    else into fresh tensors."""
    _check_points("point_x16_add_select", acc,
                  *(() if out is None else (out,)))
    for t in table:
        if t.shape != (curve.TABLE_SIZE,) + acc.x.shape:
            raise ValueError(
                f"point_x16_add_select: table {tuple(t.shape)} is not "
                f"[{curve.TABLE_SIZE}] + {tuple(acc.x.shape)}")
    if digits.ndim < 1 or digits.shape[:-1] != acc.x.shape[:-1]:
        raise ValueError(
            f"point_x16_add_select: digits {tuple(digits.shape)} do not "
            f"match points {tuple(acc.x.shape[:-1])}")
    n_win = digits.shape[-1]
    if not 0 <= w < n_win:
        raise ValueError(f"point_x16_add_select: window {w} outside "
                         f"[0, {n_win})")
    if _route(*acc, *table, digits, *(out or ())) == "cpu":
        res = point_x16_add_select_plain(acc, table, digits, w)
        if out is None:
            return res
        for dst, src in zip(out, res):
            dst.copy_(src)
        return out
    if out is None:
        out = _empty_points(acc.x)
    lib = _load()
    with torch.cuda.device(acc.x.device):
        rc = lib.point_x16_add_select(
            *(t.data_ptr() for t in acc), *(t.data_ptr() for t in table),
            digits.data_ptr(), *(t.data_ptr() for t in out),
            acc.x.numel() // fp.NWORDS, n_win, w, _stream(acc.x.device))
    _check(rc, "point_x16_add_select")
    launches["point_x16_add"] += 1
    return out


# -- the batched point decode ----------------------------------------------------

XBYTES = 48                 # a compressed x, big-endian
DECODE_WORDS = fp.NWORDS + 1  # y, then the flags
ON_CURVE, IN_SUBGROUP = 1, 2  # the flag bits
DECODE_BLOCK_POINTS = 4     # one warp of 8-lane groups (decode_points_kernel)
_Z = 0xD201000000010000     # z = -_Z, the BLS parameter: lambda = z^2 - 1
_R_MOD_P = (1 << (32 * fp.NWORDS)) % P


def decode_slots(n: int) -> int:
    """Point slots the kernel launches for n points: whole blocks."""
    return -(-n // DECODE_BLOCK_POINTS) * DECODE_BLOCK_POINTS


def _mul_z_plain(p: curve.PointVec) -> curve.PointVec:
    """[-z]P by double and add, MSB first (63 doublings, 5 additions)."""
    acc = p
    for bit in bin(_Z)[3:]:
        acc = point_double_plain(acc)
        if bit == "1":
            acc = point_add_plain(acc, p)
    return acc


def decode_points_plain(xb: torch.Tensor, wl: torch.Tensor) -> torch.Tensor:
    n, device = xb.shape[0], xb.device
    x = fp.mul_small_plain(halflimb.bytes_be_to_words(xb), _R_MOD_P)  # x R
    rhs = fp.add(fp.mul_plain(fp.mul_plain(x, x), x),
                 fp.constant(B_COEFF, (n,), device=device))
    cand = fp.pow_fixed_plain(rhs, (P + 1) // 4)
    on_curve = (fp.mul_plain(cand, cand) == rhs).all(-1)
    c = fp.from_mont_plain(cand)
    flip = fp.canonical_gt_half(c) != wl.bool()
    y_out = fp.where(flip, fp.neg(c), c)
    y = fp.where(flip, fp.neg(cand), cand)
    one = fp.constant(1, (n,), device=device)
    # [lambda]P = [-z]([-z]P) - P against phi(P) = (beta x, y)
    s = point_add_plain(_mul_z_plain(_mul_z_plain(curve.PointVec(x, y, one))),
                        curve.PointVec(x, fp.neg(y), one))
    bx = fp.mul_plain(x, fp.constant(glv.BETA, device=device))
    in_sub = ((fp.mul_plain(bx, s.z) == s.x).all(-1)
              & (fp.mul_plain(y, s.z) == s.y).all(-1))
    flags = (on_curve.to(torch.int32) * ON_CURVE
             | in_sub.to(torch.int32) * IN_SUBGROUP)
    return torch.cat([y_out, flags[:, None]], dim=-1)


def decode_points(xb: torch.Tensor, wl: torch.Tensor) -> torch.Tensor:
    """The batched decompression of n G1 points in one launch. xb: [n, 48]
    uint8, each point's big-endian x with the three flag bits cleared
    (x < p); wl: [n] uint8, 1 where the point's y is the lexicographically
    largest root. Returns [n, 13] int32: the canonical y (the root of
    x^3 + 4 that wl asks for) as 12 little-endian words, then the flags
    ON_CURVE (x^3 + 4 is a square) and IN_SUBGROUP ([lambda]P == phi(P)),
    the second meaningful only with the first."""
    if xb.ndim != 2 or xb.shape[1] != XBYTES:
        raise ValueError(f"decode_points: x bytes must be [n, {XBYTES}], got "
                         f"{tuple(xb.shape)}")
    if wl.shape != xb.shape[:1]:
        raise ValueError(f"decode_points: signs {tuple(wl.shape)} do not "
                         f"match {xb.shape[0]} points")
    if _route(xb, wl, dtype=torch.uint8) == "cpu":
        return decode_points_plain(xb, wl)
    n = xb.shape[0]
    out = torch.empty((n, DECODE_WORDS), dtype=torch.int32, device=xb.device)
    lib = _load()
    with torch.cuda.device(xb.device):
        rc = lib.decode_points(xb.data_ptr(), wl.data_ptr(), out.data_ptr(),
                               n, _stream(xb.device))
    _check(rc, "decode_points")
    launches["decode_points"] += 1
    return out


# -- the scalar field: batched multiply, and B8, its fixed-exponent ladder ------

fr_mont_mul_plain = fr.mul_plain
fr_pow_fixed_plain = fr.pow_fixed_plain


def fr_mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b / R mod r elementwise over [..., 8] scalar-field elements. The
    operands have one shape, or either is a single [8] element that
    multiplies the whole batch (read in place by the kernel)."""
    for t in (a, b):
        if t.ndim < 1 or t.shape[-1] != fr.NWORDS:
            raise ValueError(f"fr_mont_mul: bad element shape "
                             f"{tuple(t.shape)}")
    if a.shape != b.shape and a.ndim != 1 and b.ndim != 1:
        raise ValueError(f"fr_mont_mul: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ and neither is one "
                         f"element")
    if _route(a, b) == "cpu":
        return fr_mont_mul_plain(a, b)
    shape = a.shape if a.ndim >= b.ndim else b.shape
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    lib = _load()
    with torch.cuda.device(a.device):
        rc = lib.fr_mont_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                             out.numel() // fr.NWORDS,
                             int(a.shape == shape), int(b.shape == shape),
                             _stream(a.device))
    _check(rc, "fr_mont_mul")
    launches["fr_mont_mul"] += 1
    return out


def fr_pow_fixed(x: torch.Tensor, exponent: int) -> torch.Tensor:
    """x^exponent elementwise over [..., 8] scalar-field elements
    (exponent >= 1); with exponent r - 2 the inverse, 0 -> 0."""
    if exponent < 1 or exponent.bit_length() > 32 * fr.NWORDS:
        raise ValueError("fr_pow_fixed exponent must lie in [1, 2^256)")
    if x.ndim < 1 or x.shape[-1] != fr.NWORDS:
        raise ValueError(f"fr_pow_fixed: bad element shape {tuple(x.shape)}")
    if _route(x) == "cpu":
        return fr_pow_fixed_plain(x, exponent)
    out = torch.empty_like(x)
    words = (ctypes.c_uint32 * fr.NWORDS)(
        *[(exponent >> (32 * j)) & 0xFFFFFFFF for j in range(fr.NWORDS)])
    lib = _load()
    with torch.cuda.device(x.device):
        rc = lib.fr_pow_fixed(
            x.data_ptr(), out.data_ptr(), x.numel() // fr.NWORDS, words,
            exponent.bit_length(), _stream(x.device))
    _check(rc, "fr_pow_fixed")
    launches["fr_pow_fixed"] += 1
    return out


# -- the transcript: STROBE-128 absorb and challenge -----------------------------

STROBE_R = 166
STATE_BYTES = 200
FLAG_I, FLAG_A, FLAG_C, FLAG_M = 1, 2, 4, 16      # STROBE operation flags

f1600_plain = keccak_dev.f1600


def _run_f_plain(st: torch.Tensor, pos: int, pb) -> torch.Tensor:
    """STROBE's run_f on a fresh copy (pb: int or a one-byte tensor)."""
    st = st.clone()
    st[pos] ^= pb
    st[pos + 1] ^= 0x04
    st[STROBE_R + 1] ^= 0x80
    return f1600_plain(st)


def strobe_absorb_stream_plain(state: torch.Tensor, stream: torch.Tensor,
                               pos: int, pbs: torch.Tensor,
                               final_pb: Optional[int] = None) -> torch.Tensor:
    st = state.clone()
    n = stream.shape[0]
    off = crossing = 0
    while off < n:
        take = min(STROBE_R - pos, n - off)
        st[pos:pos + take] ^= stream[off:off + take]
        pos += take
        off += take
        if pos == STROBE_R:
            st = _run_f_plain(st, STROBE_R, pbs[crossing])
            crossing += 1
            pos = 0
    if final_pb is not None and pos != 0:
        st = _run_f_plain(st, pos, final_pb)
    return st


def _check_strobe(name: str, state: torch.Tensor, pos: int) -> None:
    if state.shape != (STATE_BYTES,):
        raise ValueError(f"{name}: state must be [200], got "
                         f"{tuple(state.shape)}")
    if not 0 <= pos < STROBE_R:
        raise ValueError(f"{name}: position {pos} outside the rate")


def strobe_absorb_stream(state: torch.Tensor, stream: torch.Tensor, pos: int,
                         pbs: torch.Tensor,
                         final_pb: Optional[int] = None) -> torch.Tensor:
    """The [200] uint8 STROBE state after XORing the [n] uint8 `stream`
    into the rate from position `pos` on. The permutation runs at every
    rate crossing with that crossing's pos_begin, `pbs[c]` ([crossings]
    uint8); with `final_pb` given, once more after the stream when the
    position is not 0 (the forced permutation of a PRF operation, begun at
    final_pb). Returns a fresh tensor."""
    _check_strobe("strobe_absorb_stream", state, pos)
    n = stream.shape[0] if stream.ndim == 1 else -1
    if n < 0 or pbs.ndim != 1 or pbs.shape[0] != (pos + n) // STROBE_R:
        raise ValueError(
            f"strobe_absorb_stream: stream {tuple(stream.shape)} from "
            f"position {pos} does not cross the rate {tuple(pbs.shape)} "
            f"times")
    if final_pb is not None and not 0 <= final_pb <= STROBE_R:
        raise ValueError(f"strobe_absorb_stream: bad final_pb {final_pb}")
    if _route(state, stream, pbs, dtype=torch.uint8) == "cpu":
        return strobe_absorb_stream_plain(state, stream, pos, pbs, final_pb)
    out = torch.empty_like(state)
    lib = _load()
    with torch.cuda.device(state.device):
        rc = lib.strobe_absorb_stream(
            state.data_ptr(), out.data_ptr(), stream.data_ptr(), n, pos,
            pbs.data_ptr(), int(final_pb is not None), final_pb or 0,
            _stream(state.device))
    _check(rc, "strobe_absorb_stream")
    launches["strobe_absorb_stream"] += 1
    return out


def _absorb_bytes_plain(st: torch.Tensor, data: bytes, pos: int,
                        pos_begin: int):
    """Byte-wise STROBE absorb with the positions tracked on the host;
    returns (state, pos, pos_begin)."""
    st = st.clone()
    for v in data:
        st[pos] ^= v
        pos += 1
        if pos == STROBE_R:
            st = _run_f_plain(st, pos, pos_begin)
            pos = pos_begin = 0
    return st, pos, pos_begin


def _begin_op_plain(st, flags: int, pos: int, pos_begin: int, force_f: bool):
    st, pos, pb = _absorb_bytes_plain(st, bytes([pos_begin]), pos, pos + 1)
    st, pos, pb = _absorb_bytes_plain(st, bytes([flags]), pos, pb)
    if force_f and pos != 0:
        st, pos, pb = _run_f_plain(st, pos, pb), 0, 0
    return st, pos, pb


def _header32_plain(st, label: bytes, pos: int, pos_begin: int):
    st, pos, pb = _begin_op_plain(st, FLAG_M | FLAG_A, pos, pos_begin,
                                  False)
    return _absorb_bytes_plain(st, label + bytes([32, 0, 0, 0]), pos, pb)


def strobe_challenge32_plain(state: torch.Tensor, label: bytes, pos: int,
                             pos_begin: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rejection loop decides on the host (one fetch an attempt): this
    is the CPU path and the yardstick, not the card's main path."""
    st, pb = state, pos_begin
    while True:
        st, pos, pb = _header32_plain(st, label, pos, pb)
        st, pos, pb = _begin_op_plain(st, FLAG_I | FLAG_A | FLAG_C, pos,
                                      pb, True)
        chal = st[pos:pos + 32].clone()
        st = st.clone()
        st[pos:pos + 32].zero_()
        pos += 32
        if int.from_bytes(bytes(chal.tolist()), "big") < FR_MODULUS:
            break
    st, pos, pb = _header32_plain(st, label, pos, pb)
    st, pos, pb = _begin_op_plain(st, FLAG_A, pos, pb, False)
    st = st.clone()
    for i in range(32):
        st[pos] ^= chal[i]
        pos += 1
        if pos == STROBE_R:
            st, pos, pb = _run_f_plain(st, pos, pb), 0, 0
    return st, chal


@functools.lru_cache(maxsize=256)
def _label_on(label: bytes, device: torch.device) -> torch.Tensor:
    """A challenge label over 32 bytes on `device`, where the kernel reads
    it: uploaded once per label and device."""
    return halflimb.upload(list(label), torch.uint8, device)


def strobe_challenge32(state: torch.Tensor, label: bytes, pos: int,
                       pos_begin: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The transcript's get_and_append_challenge on a [200] uint8 STROBE
    state at (pos, pos_begin): 32-byte challenges are squeezed under
    `label` (of any length) until one is below r, and the accepted one is
    absorbed back as a message under the same label. Returns (state,
    challenge [32] uint8 big-endian), fresh tensors; the decision to
    accept is taken on the device, in one launch."""
    _check_strobe("strobe_challenge32", state, pos)
    if not 0 <= pos_begin <= STROBE_R:
        raise ValueError(f"strobe_challenge32: bad pos_begin {pos_begin}")
    if _route(state, dtype=torch.uint8) == "cpu":
        return strobe_challenge32_plain(state, label, pos, pos_begin)
    label = bytes(label)
    label_dev = _label_on(label, state.device) if len(label) > 32 else None
    out = torch.empty_like(state)
    chal = torch.empty(32, dtype=torch.uint8, device=state.device)
    lib = _load()
    with torch.cuda.device(state.device):
        rc = lib.strobe_challenge32(
            state.data_ptr(), out.data_ptr(), chal.data_ptr(), label,
            None if label_dev is None else label_dev.data_ptr(), len(label),
            pos, pos_begin, _stream(state.device))
    _check(rc, "strobe_challenge32")
    launches["strobe_challenge32"] += 1
    return out, chal
