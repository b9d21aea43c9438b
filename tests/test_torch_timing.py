"""The port's timing helpers (tpu3d_torch.utils.timing) against the JAX
package's names, arguments and return keys, on CPU tensors; and the last
two functions ported, ``voxel_count`` and ``smallest_eigvec_3x3_planes``,
against JAX's on seeded inputs."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu3d.utils
import tpu3d_torch.utils
from tpu3d.ops.normals import smallest_eigvec_3x3_planes as jax_planes
from tpu3d.ops.voxel import voxel_count as jax_voxel_count
from tpu3d.types import PointCloud as JaxCloud
from tpu3d.utils.timing import device_timeit as jax_device_timeit
from tpu3d_torch.ops.normals import smallest_eigvec_3x3_planes
from tpu3d_torch.ops.voxel import voxel_count
from tpu3d_torch.types import PointCloud
from tpu3d_torch.utils import StageTimer, device_timeit, roundtrip_ms
from torch_threads import one_torch_thread  # noqa: F401


def test_exports_cover_jax():
    assert set(tpu3d.utils.__all__) <= set(tpu3d_torch.utils.__all__)
    for name in ("device_timeit", "StageTimer"):
        ours = inspect.signature(getattr(tpu3d_torch.utils, name))
        theirs = inspect.signature(getattr(tpu3d.utils, name))
        assert list(ours.parameters) == list(theirs.parameters)
    assert "n" in inspect.signature(roundtrip_ms).parameters


def test_device_timeit_keys_and_order():
    x = torch.randn(64, 3)
    out = device_timeit(
        lambda a: {"sum": a.sum(0), "rows": (a * 2.0, a > 0)}, x,
        iters=4, warmup=1)
    ref = jax_device_timeit(lambda a: a * 2.0, jnp.ones(4), iters=2)
    assert set(out) == set(ref)
    assert 0.0 < out["best_ms"] <= out["mean_ms"]
    assert out["roundtrip_ms"] > 0.0
    assert out["best_net_ms"] >= 0.0
    assert out["best_net_ms"] == max(out["best_ms"] - out["roundtrip_ms"],
                                     0.0)


def test_device_timeit_without_tensors():
    calls = []
    out = device_timeit(lambda: calls.append(1), iters=2, warmup=1)
    assert len(calls) == 3 and out["best_ms"] <= out["mean_ms"]


def test_stage_timer_records_and_reports(capsys):
    timer = StageTimer()
    y = timer.time("double", lambda a: a * 2.0, torch.ones(8))
    assert torch.equal(y, torch.full((8,), 2.0))
    assert list(timer.stages) == ["double"] and timer.stages["double"] >= 0.0
    timer.report()
    assert capsys.readouterr().out.startswith("  double: ")


def test_roundtrip_ms_positive():
    assert roundtrip_ms(n=4, device="cpu") > 0.0


@pytest.mark.parametrize("voxel", [0.05, 0.013])
def test_voxel_count_matches_jax(voxel):
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.5, 0.5, (3000, 3)).astype(np.float32)
    got = voxel_count(PointCloud.from_numpy(pts, capacity=3072,
                                            device="cpu"), voxel)
    ref = jax_voxel_count(JaxCloud.from_numpy(pts, capacity=3072), voxel)
    assert got.ndim == 0 and got.dtype == torch.int32
    assert int(got) == int(ref)


def test_smallest_eigvec_planes_matches_jax():
    """Covariances of random anisotropic neighbourhoods, a rank-deficient
    (planar) one and a multiple of the identity: |cos| ≥ 0.9999 against
    JAX's, e_z on the degenerate one."""
    rng = np.random.default_rng(5)
    n = 400
    pts = rng.normal(size=(n, 20, 3)) * rng.uniform(0.01, 1.0, (n, 1, 3))
    c = pts - pts.mean(1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", c, c).astype(np.float32)
    cov[0] = np.diag([1.0, 2.0, 0.0])
    cov[1] = np.eye(3) * 0.5
    comps = [cov[:, i, j] for i, j in
             ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]
    got = np.stack([v.numpy() for v in smallest_eigvec_3x3_planes(
        *(torch.from_numpy(x) for x in comps))], 1)
    ref = np.stack([np.asarray(v) for v in jax_planes(
        *(jnp.asarray(x) for x in comps))], 1)
    cos = np.abs((got * ref).sum(1))
    assert cos.min() >= 0.9999
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(got[1], [0.0, 0.0, 1.0])
