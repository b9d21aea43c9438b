"""Device meshes, row-sharded tensors and collectives for one controller.

Counterpart of ``tpu3d/parallel/mesh.py`` and of the ``shard_map``
collectives the JAX stack calls (``all_gather``, ``psum``, ``ppermute``,
``axis_index``). JAX runs one controller: ``shard_map`` runs a local
function per device and the collectives join the shards. The port keeps
that model in one Python process:

  * :class:`Mesh` is an ordered grid of ``torch.device`` s with named axes.
  * :class:`ShardedRows` holds one logical array split evenly by rows over
    a mesh axis, one tensor per shard on its device, with the global row
    offsets (the counterpart of an array placed with ``row_sharded``).
  * :func:`for_shards` runs a local function once per shard of an axis,
    under ``torch.cuda.device(shard device)``, with row-sharded arguments
    cut to the shard and every other tensor copied to its device. The
    shards are issued one after another; on several cards their kernels
    then overlap wherever the local function does not read back to the
    host. :func:`axis_index` is the running shard's index.
  * :func:`all_gather` stacks per-shard values onto the lead device,
    :func:`psum` adds them there, :func:`ppermute` moves them along pairs
    (a shard that receives nothing gets zeros, as in JAX).

A mesh may list one device more than once: a virtual mesh, the port's
counterpart of ``--xla_force_host_platform_device_count``. Its shards run
one after another on that device with the same kernels at shard shapes.
:func:`see_first_device` makes :func:`visible_devices` report the first
device of a type ``n`` times, so that ``parallel_mesh`` and the pipeline
take the sharded route on one card or on the CPU.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tpu3d_torch.device import on_device

_VIRTUAL: dict = {}  # device type -> how many times the first is seen
_LOCAL = threading.local()


def see_first_device(n: int, device_type: str = "cuda") -> None:
    """Make :func:`visible_devices` report the first ``device_type`` device
    ``n`` times (``n`` ≤ 0 restores the real list)."""
    if n > 0:
        _VIRTUAL[device_type] = int(n)
    else:
        _VIRTUAL.pop(device_type, None)


def visible_devices(device_type: str = "cuda") -> list[torch.device]:
    """The devices a mesh is built over by default: every CUDA device (or
    the CPU), or the first one repeated after :func:`see_first_device`."""
    first = torch.device("cuda:0" if device_type == "cuda" else device_type)
    if device_type in _VIRTUAL:
        return [first] * _VIRTUAL[device_type]
    if device_type == "cuda":
        return [torch.device(f"cuda:{i}")
                for i in range(torch.cuda.device_count())]
    return [first]


class Mesh:
    """An ordered grid of devices with named axes. ``shape`` maps each
    axis name to its size, ``devices`` is the (object) array of devices,
    as in ``jax.sharding.Mesh``."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis``, every other axis at index 0."""
        k = self.axis_names.index(axis)
        sel = tuple(slice(None) if i == k else 0
                    for i in range(len(self.axis_names)))
        return list(self.devices[sel])

    def take(self, axis: str, index: int) -> "Mesh":
        """The mesh of the devices at ``index`` along ``axis``, without it."""
        k = self.axis_names.index(axis)
        return Mesh(np.take(self.devices, index, axis=k),
                    self.axis_names[:k] + self.axis_names[k + 1:])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {list(self.devices.reshape(-1))})"


def make_mesh(
    axis_names: Sequence[str] = ("shard",),
    shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A mesh over ``devices`` (default: :func:`visible_devices`). With one
    axis every device goes to it; with more, ``shape`` picks the split and
    by default puts everything on the last axis."""
    devices = [torch.device(d) for d in (
        visible_devices() if devices is None else devices)]
    n = len(devices)
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != device count {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(shape)), axis_names)


class ShardedRows:
    """One logical array split evenly by rows over a mesh axis: shard s
    holds rows [s·shard_rows, (s+1)·shard_rows) on ``devices[s]``."""

    def __init__(self, shards: Sequence[torch.Tensor]):
        self.shards = list(shards)
        rows = {s.shape[0] for s in self.shards}
        if len(rows) != 1:
            raise ValueError(f"shards differ in rows: {sorted(rows)}")
        self.shard_rows = rows.pop()

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def rows(self) -> int:
        return self.shard_rows * self.n_shards

    @property
    def offsets(self) -> list[int]:
        return [s * self.shard_rows for s in range(self.n_shards)]

    def row(self, i: int) -> torch.Tensor:
        """Global row ``i``, on its shard's device."""
        return self.shards[i // self.shard_rows][i % self.shard_rows]

    def gather(self) -> torch.Tensor:
        """The whole array on the lead (first) device."""
        return all_concat(self.shards)


class RowSharding:
    """Rows split over ``axis`` (counterpart of ``NamedSharding(mesh,
    P(axis))``)."""

    def __init__(self, mesh: Mesh, axis: str):
        self.mesh, self.axis = mesh, axis

    def put(self, x: torch.Tensor) -> ShardedRows:
        devs = self.mesh.axis_devices(self.axis)
        n = len(devs)
        if x.shape[0] % n:
            raise ValueError(f"rows {x.shape[0]} not divisible by {n} shards")
        rows = x.shape[0] // n
        return ShardedRows([x[s * rows:(s + 1) * rows].to(d)
                            for s, d in enumerate(devs)])


class Replicated:
    """Every shard sees the whole array (counterpart of
    ``NamedSharding(mesh, P())``): it lives on the lead device and
    :func:`for_shards` copies it to each shard's device."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def put(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.mesh.devices.reshape(-1)[0])


def row_sharded(mesh: Mesh, axis: str = "shard") -> RowSharding:
    """Shard the leading (row) dimension across ``axis``."""
    return RowSharding(mesh, axis)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def shard_rows_of(x, mesh: Mesh, axis: str) -> ShardedRows:
    """``x`` as a :class:`ShardedRows` over ``axis``: placed by rows when a
    tensor, checked against the axis when already sharded."""
    if isinstance(x, ShardedRows):
        if x.n_shards != mesh.shape[axis]:
            raise ValueError(f"{x.n_shards} shards on a {mesh.shape[axis]}"
                             f"-way axis {axis!r}")
        return x
    return RowSharding(mesh, axis).put(x)


def axis_index() -> int:
    """The index along the mapped axis of the shard :func:`for_shards` is
    running (``jax.lax.axis_index``)."""
    sid = getattr(_LOCAL, "sid", None)
    if sid is None:
        raise RuntimeError("axis_index() outside for_shards")
    return sid


def for_shards(mesh: Mesh, axis: str, fn: Callable, *args) -> list:
    """``fn(*local_args)`` once per shard of ``axis``, in shard order:
    :class:`ShardedRows` arguments are cut to the shard, tensors copied to
    its device, anything else passed as it is. Returns the per-shard
    results."""
    out = []
    for sid, dev in enumerate(mesh.axis_devices(axis)):
        local = [
            a.shards[sid] if isinstance(a, ShardedRows)
            else a.to(dev) if isinstance(a, torch.Tensor) else a
            for a in args
        ]
        _LOCAL.sid = sid
        try:
            with on_device(dev):
                out.append(fn(*local))
        finally:
            _LOCAL.sid = None
    return out


def all_concat(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-shard tensors concatenated along rows on the lead device."""
    lead = xs[0].device
    return torch.cat([x.to(lead) for x in xs])


def all_gather(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-shard values stacked along a new leading axis on the lead
    device (``jax.lax.all_gather``)."""
    lead = xs[0].device
    return torch.stack([x.to(lead) for x in xs])


def psum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of the per-shard values, in shard order, on the lead
    device (``jax.lax.psum``)."""
    lead = xs[0].device
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(lead)
    return total


def ppermute(xs: Sequence[torch.Tensor],
             perm: Sequence[tuple[int, int]]) -> list[torch.Tensor]:
    """Shard j receives shard i's value for each (i, j) in ``perm``, on
    its own device; a shard that receives nothing gets zeros
    (``jax.lax.ppermute``)."""
    out = [torch.zeros_like(x) for x in xs]
    for src, dst in perm:
        out[dst] = xs[src].to(xs[dst].device)
    return out
