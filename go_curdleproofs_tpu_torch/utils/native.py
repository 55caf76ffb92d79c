"""The port's optional host C library: Keccak-f[1600], the bulk
STROBE/Merlin transcript operations and the G1 host group operations
(go_curdleproofs_tpu_torch/native/*.c).

`lib()` compiles the sources with the host C compiler into
`go_curdleproofs_tpu_torch/_build/libcurdle_host.so` at first use, again
whenever their hash changes, and loads it with ctypes. It is an accelerator
of host code only: with no C compiler (or a failed build) `lib()` returns
None and every caller runs its Python path, byte for byte the same. It
hides neither the device nor a kernel. `with disabled():` forces the
Python path (the tests hold the two against each other).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_CSRC = Path(__file__).resolve().parents[1] / "native"
_SOURCES = ("keccak.c", "strobe.c", "codec.c")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
LIB_NAME = "libcurdle_host.so"
CC_FLAGS = ["-O3", "-fPIC", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_enabled = True


def _sources_hash() -> str:
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(CC_FLAGS).encode())
    return h.hexdigest()


def build() -> Optional[Path]:
    """Compile the host library unless a build of the current sources is
    there. Returns its path, or None when there is no C compiler or the
    compile fails."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _sources_hash()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    res = subprocess.run([cc, *CC_FLAGS, "-o", str(tmp),
                          *(str(_CSRC / s) for s in _SOURCES)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    cp, i32 = ctypes.c_char_p, ctypes.c_int32
    pos3 = ctypes.POINTER(ctypes.c_int32)
    lib.keccak_f1600.argtypes = [cp]
    lib.keccak_f1600.restype = None
    lib.merlin_append_msgs.argtypes = [cp, pos3, cp, i32, cp, i32, i32]
    lib.merlin_append_msgs.restype = None
    lib.transcript_challenges.argtypes = [cp, pos3, cp, i32, cp, i32]
    lib.transcript_challenges.restype = None
    lib.g1_decompress.argtypes = [cp] * 3
    lib.g1_decompress.restype = ctypes.c_int
    lib.g1_subgroup_check.argtypes = [cp] * 2
    lib.g1_subgroup_check.restype = ctypes.c_int
    lib.g1_mul_host.argtypes = [cp, i32, cp, i32, cp]
    lib.g1_mul_host.restype = ctypes.c_int
    lib.g1_add_host.argtypes = [cp, i32, cp, i32, cp]
    lib.g1_add_host.restype = ctypes.c_int
    lib.g1_combine_windows_host.argtypes = [cp, cp, i32, i32, cp]
    lib.g1_combine_windows_host.restype = ctypes.c_int


def lib() -> Optional[ctypes.CDLL]:
    """The loaded host library, or None (Python paths run)."""
    global _lib, _tried
    if not _enabled:
        return None
    if not _tried:
        with _lock:
            if not _tried:
                path = build()
                if path is not None:
                    try:
                        loaded = ctypes.CDLL(str(path))
                        _declare(loaded)
                        _lib = loaded
                    except (OSError, AttributeError):
                        _lib = None
                _tried = True
    return _lib


@contextlib.contextmanager
def disabled():
    """Inside the block every caller takes its Python path."""
    global _enabled
    before, _enabled = _enabled, False
    try:
        yield
    finally:
        _enabled = before
