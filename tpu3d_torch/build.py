"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``
(all started together), then linked into one shared library with a plain
C interface, on first use, into
``tpu3d_torch/_build/`` (git-ignored; the file name carries a hash of the
sources, so an edited source is rebuilt). The library is loaded with
``ctypes``. Each C entry point launches on the stream it is given and
returns ``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double

# C entry points and their argument types (pointers, ints, floats, doubles,
# and the stream last).
SIGNATURES = {
    "tpu3d_nn_top1": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    "tpu3d_nn_desc_top1": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                           _P, _P],
    "tpu3d_ransac_score": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P, _P,
                           _P, _P, _P],
    "tpu3d_icp_p2plane_stats": [_P] * 4 + [_I] * 3 + [_P, _F, _F, _I]
    + [_P] * 7,
    "tpu3d_moments_sweep": [_P, _P, _P, _P, _I, _I, _I, _F, _P, _P],
    "tpu3d_spfh_sweep": [_P, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P],
    "tpu3d_fpfh_sweep": [_P] * 5 + [_I] * 5 + [_F, _P, _P],
    "tpu3d_bilateral_filter": [_P, _P, _I, _I, _I, _D, _F, _P],
    "tpu3d_nn_walk_top1": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P,
                           _P, _P],
    "tpu3d_probe_unary": [_P, _I, _I, _P, _P],
    "tpu3d_probe_argmin": [_P, _I, _I, _P, _P],
    "tpu3d_probe_cumsum": [_P, _I, _I, _P, _P],
    "tpu3d_probe_dot_axis0": [_P, _P, _I, _I, _I, _I, _P, _P],
    "tpu3d_probe_transpose": [_P, _I, _P, _P],
}

# Serialises the first build: the pipeline's prepare threads can reach
# their first kernel together.
_BUILD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: CUDA kernels cannot be built")
    return found


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise on the first failure, else return
    their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library for these sources exists;
    returns its path. ``verbose`` adds ``-Xptxas -v`` and prints the
    compiler's report (registers, shared memory, spills per kernel)."""
    lib = BUILD_DIR / f"libtpu3d_kernels_{_digest()}.so"
    if lib.exists() and not verbose:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objs = [os.path.join(objdir, p.stem + ".o") for p in _sources()]
        report = _run_all([
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", obj]
            + (["-Xptxas", "-v"] if verbose else [])
            for src, obj in zip(_sources(), objs)
        ])
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            _run_all([[nvcc, "-shared", *objs, "-o", tmp]])
        except RuntimeError:
            os.unlink(tmp)
            raise
    if verbose:
        print(report)
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call; concurrent first
    calls build once)."""
    with _BUILD_LOCK:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise when a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's ``launches`` count. The pipeline's
    prepare threads launch kernels at once, so the count is locked."""
    with _COUNT_LOCK:
        wrapper.launches += 1
