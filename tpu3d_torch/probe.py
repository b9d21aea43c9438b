"""Device-math probe: the counterpart of ``benchmarks/pallas_probe.py``.

The JAX package's probe asks which operations lower through Mosaic on a
TPU (arctan2, argmin, arctan, a lane cumsum, arccos, cos, an axis-0
``dot_general`` and a 128 × 128 ``swapaxes``), one ``pallas_call`` each.
On the H100 every one of them compiles, so this probe asks the question
that remains for the port's kernels: how far the card's own math, in CUDA
C++ (``csrc/probe.cu``, one launch per function), lies from PyTorch's on
the same card and inputs. Each function has a kernel wrapper (CUDA tensors
launch it, CPU tensors take the plain version) and a plain PyTorch version.

    python -c "import tpu3d_torch.probe as p; p.main()"

prints one line per function and returns non-zero on any mismatch. The
probe's inputs are the JAX probe's: ``linspace(-2, 2)`` as (8, 256), and
``linspace(0, 1)`` as (128, 128) with a (31, 128) matrix of ones for the
contraction (whose product the JAX probe hides behind ``* 0.0 + i``; here
the product itself is compared).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu3d_torch import build
from tpu3d_torch.device import launches_kernel, on_device

UNARY = ("atan2", "atan", "acos", "cos")
# The CUDA math library's documented maximum ulp errors (CUDA C++
# Programming Guide, "Mathematical Functions": atan2f 3, atanf 2, acosf 2,
# cosf 2). Two results each within B ulp of the exact value lie within 2B
# ulp of each other: the tolerance against PyTorch's on the card.
ULP_BOUND = {"atan2": 3, "atan": 2, "acos": 2, "cos": 2}
_U = 2.0 ** -24  # fp32 unit roundoff


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _float32(*xs):
    if any(x.dtype != torch.float32 for x in xs):
        raise TypeError("the probe takes float32 tensors")


def unary_plain(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "atan2":
        return torch.atan2(x, torch.full_like(x, 0.5))
    if name == "atan":
        return torch.atan(x)
    if name == "acos":
        return torch.acos(torch.clamp(x, -1.0, 1.0))
    if name == "cos":
        return torch.cos(x)
    raise ValueError(f"unknown function {name!r}")


def unary(x: torch.Tensor, name: str) -> torch.Tensor:
    """atan2(x, 0.5), atan(x), acos(clip(x, -1, 1)) or cos(x)."""
    if name not in UNARY:
        raise ValueError(f"unknown function {name!r}")
    _float32(x)
    if not launches_kernel(x):
        return unary_plain(x, name)
    x = x.contiguous()
    out = torch.empty_like(x)
    with on_device(x.device):
        rc = build.library().tpu3d_probe_unary(
            x.data_ptr(), x.numel(), UNARY.index(name), out.data_ptr(),
            _stream(x))
    build.check(rc, "tpu3d_probe_unary")
    build.count_launch(unary)
    return out


def row_argmin_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.argmin(x, dim=1).to(torch.int32)


def row_argmin(x: torch.Tensor) -> torch.Tensor:
    """i32[rows]: the first least column of each row of f32[rows, cols]."""
    _float32(x)
    if x.ndim != 2 or x.shape[1] < 1:
        raise ValueError("row_argmin takes a (rows, cols >= 1) matrix")
    if not launches_kernel(x):
        return row_argmin_plain(x)
    x = x.contiguous()
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    with on_device(x.device):
        rc = build.library().tpu3d_probe_argmin(
            x.data_ptr(), x.shape[0], x.shape[1], out.data_ptr(), _stream(x))
    build.check(rc, "tpu3d_probe_argmin")
    build.count_launch(row_argmin)
    return out


def row_cumsum_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's order of additions: each 32-wide piece of a row scanned
    by five shifted adds (element i adds element i − d, d = 1 … 16), then
    the carry, the previous piece's last sum, added to every element."""
    rows, cols = x.shape
    out = torch.empty_like(x)
    carry = torch.zeros((rows, 1), dtype=x.dtype, device=x.device)
    for c0 in range(0, cols, 32):
        w = min(32, cols - c0)
        v = torch.nn.functional.pad(x[:, c0:c0 + w], (0, 32 - w))
        for d in (1, 2, 4, 8, 16):
            v = torch.cat([v[:, :d], v[:, d:] + v[:, :-d]], dim=1)
        v = v + carry
        out[:, c0:c0 + w] = v[:, :w]
        carry = v[:, 31:32]
    return out


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along each row, in column order."""
    _float32(x)
    if x.ndim != 2:
        raise ValueError("row_cumsum takes a matrix")
    if not launches_kernel(x):
        return row_cumsum_plain(x)
    x = x.contiguous()
    out = torch.empty_like(x)
    with on_device(x.device):
        rc = build.library().tpu3d_probe_cumsum(
            x.data_ptr(), x.shape[0], x.shape[1], out.data_ptr(), _stream(x))
    build.check(rc, "tpu3d_probe_cumsum")
    build.count_launch(row_cumsum)
    return out


def dot_axis0_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.T @ b[:, :a.shape[0]].T


def dot_axis0(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[p, q] = Σ_k a[k, p] · b[q, k] over a's k rows: the probe's
    ``dot_general(a, b[:, :k], contracting ((0,), (1,)))``."""
    _float32(a, b)
    if a.ndim != 2 or b.ndim != 2 or a.shape[0] > b.shape[1]:
        raise ValueError("dot_axis0 takes a (k, p) and a (q, >= k) matrix")
    if not launches_kernel(a, b):
        return dot_axis0_plain(a, b)
    a, b = a.contiguous(), b.contiguous()
    k, p = a.shape
    q = b.shape[0]
    out = torch.empty((p, q), dtype=torch.float32, device=a.device)
    with on_device(a.device):
        rc = build.library().tpu3d_probe_dot_axis0(
            a.data_ptr(), b.data_ptr(), k, p, q, b.shape[1], out.data_ptr(),
            _stream(a))
    build.check(rc, "tpu3d_probe_dot_axis0")
    build.count_launch(dot_axis0)
    return out


def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    return x.T.contiguous()


def transpose(x: torch.Tensor) -> torch.Tensor:
    """The transpose of a square f32 matrix."""
    _float32(x)
    if x.ndim != 2 or x.shape[0] != x.shape[1]:
        raise ValueError("transpose takes a square matrix")
    if not launches_kernel(x):
        return transpose_plain(x)
    x = x.contiguous()
    out = torch.empty_like(x)
    with on_device(x.device):
        rc = build.library().tpu3d_probe_transpose(
            x.data_ptr(), x.shape[0], out.data_ptr(), _stream(x))
    build.check(rc, "tpu3d_probe_transpose")
    build.count_launch(transpose)
    return out


for _fn in (unary, row_argmin, row_cumsum, dot_axis0, transpose):
    _fn.launches = 0
WRAPPERS = {"unary": unary, "row_argmin": row_argmin,
            "row_cumsum": row_cumsum, "dot_axis0": dot_axis0,
            "transpose": transpose}


def probe_inputs(device):
    """The JAX probe's inputs: x f32[8, 256], y f32[128, 128], a f32[31,
    128] of ones."""
    x = torch.from_numpy(
        np.linspace(-2, 2, 8 * 256).reshape(8, 256).astype(np.float32))
    y = torch.from_numpy(
        np.linspace(0, 1, 128 * 128).reshape(128, 128).astype(np.float32))
    return x.to(device), y.to(device), torch.ones(31, 128, device=device)


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in fp32 ulps (ordered bit patterns) between two
    finite fp32 tensors."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def _within(k, p, tol):
    """(max abs error, its elementwise tolerance's max, 'abs', ok)."""
    err = (k.double() - p.double()).abs()
    return float(err.max()), float(tol.max()), "abs", bool((err <= tol).all())


def cases(device):
    """[(name, kernel call, plain call, compare)] for every probed function.
    ``compare(kernel_out, plain_out)`` returns (error, tolerance, unit,
    ok)."""
    x, y, a = probe_inputs(device)

    def ulps(name):
        def compare(k, p):
            err, tol = ulp_distance(k, p), 2 * ULP_BOUND[name]
            return err, tol, "ulp", err <= tol
        return compare

    def exact(k, p):
        err = int((k != p).sum())
        return err, 0, "elements differing", err == 0

    def dot_tol(k, p):
        kk = a.shape[0]
        return _within(k, p, 2 * kk * _U * (a.abs().double().T
                                            @ y[:, :kk].abs().double().T))

    out = [(name, (lambda n=name: unary(x, n)),
            (lambda n=name: unary_plain(x, n)), ulps(name))
           for name in UNARY]
    out += [
        ("argmin", lambda: row_argmin(x), lambda: row_argmin_plain(x), exact),
        ("cumsum", lambda: row_cumsum(x), lambda: row_cumsum_plain(x),
         exact),
        ("dot_axis0", lambda: dot_axis0(a, y), lambda: dot_axis0_plain(a, y),
         dot_tol),
        ("transpose", lambda: transpose(y), lambda: transpose_plain(y),
         exact),
    ]
    return out


def run(device) -> list[dict]:
    """Every probed function's kernel (or, on the CPU, plain version)
    against the plain version: a list of {name, err, tol, unit, ok}."""
    results = []
    for name, kern, plain, compare in cases(device):
        err, tol, unit, ok = compare(kern(), plain())
        results.append({"name": name, "err": err, "tol": tol, "unit": unit,
                        "ok": ok})
    return results


def main(device: str = "cuda") -> int:
    if device == "cuda" and not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    results = run(torch.device(device))
    for r in results:
        print(f"{r['name']}: {'OK' if r['ok'] else 'FAIL'} (max {r['unit']} "
              f"{r['err']:.3g}, tolerance {r['tol']:.3g})", file=sys.stderr)
    return 0 if all(r["ok"] for r in results) else 1
