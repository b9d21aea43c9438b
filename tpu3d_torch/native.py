"""ctypes bindings for the port's host runtime (csrc/host/tpu3d_native.cpp):
the threaded PLY parser and the nearest mask resize.

Counterpart of ``tpu3d/native.py``. The C++ source is the port's own copy;
``g++`` compiles it at first use into ``tpu3d_torch/_build/`` (the file
name carries a hash of the source and flags, so an edited source is
rebuilt), under the same lock as the CUDA kernels' build. As in the JAX
package the library is an accelerator, not a requirement: without a host
compiler :func:`available` is False and callers take the numpy path, and a
file the C++ parser declines takes the numpy reader.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from tpu3d_torch import build

SOURCE = build.CSRC / "host" / "tpu3d_native.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]


def _digest() -> str:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile the host runtime unless a library for this source exists;
    returns its path."""
    lib = build.BUILD_DIR / f"libtpu3d_native_{_digest()}.so"
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host runtime cannot be built")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build.BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(build_library()))
    except (OSError, RuntimeError):
        return None
    lib.t3d_version.restype = ctypes.c_int
    lib.t3d_load_ply.restype = ctypes.c_int
    lib.t3d_load_ply.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.t3d_free.argtypes = [ctypes.c_void_p]
    lib.t3d_resize_mask_nearest.restype = ctypes.c_int
    lib.t3d_resize_mask_nearest.argtypes = [
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    return lib if lib.t3d_version() == 1 else None


def _library() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call (concurrent first calls
    build once), or None where it cannot be built."""
    with build._BUILD_LOCK:
        return _load()


def available() -> bool:
    return _library() is not None


def load_ply(path: str):
    """Native PLY load → (points f32[N,3], colors f32[N,3] | None), or None
    when the library is unavailable or the parser declines the file."""
    lib = _library()
    if lib is None:
        return None
    pts_p = ctypes.POINTER(ctypes.c_float)()
    col_p = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int(0)
    rc = lib.t3d_load_ply(path.encode(), ctypes.byref(pts_p),
                          ctypes.byref(col_p), ctypes.byref(n))
    if rc != 0 or n.value <= 0:
        return None
    count = n.value
    pts = np.ctypeslib.as_array(pts_p, shape=(count, 3)).copy()
    cols = None
    if col_p:
        cols = np.ctypeslib.as_array(col_p, shape=(count, 3)).copy()
    lib.t3d_free(ctypes.cast(pts_p, ctypes.c_void_p))
    if col_p:
        lib.t3d_free(ctypes.cast(col_p, ctypes.c_void_p))
    return pts, cols


def resize_mask_nearest_threshold(
    mask: np.ndarray, out_h: int, out_w: int
) -> Optional[np.ndarray]:
    """Native nearest resize + binarise (> 10 → 255), the library choosing
    its threads from the output's size; None when the library is
    unavailable."""
    lib = _library()
    if lib is None:
        return None
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    out = np.empty((out_h, out_w), np.uint8)
    rc = lib.t3d_resize_mask_nearest(
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        mask.shape[0], mask.shape[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        out_h, out_w, 0,
    )
    return out if rc == 0 else None
