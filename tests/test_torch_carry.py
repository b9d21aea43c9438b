"""The PyTorch port's state carry, config and import hygiene."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu3d.config import RegistrationConfig as JaxRegistrationConfig
from tpu3d_torch import carry
from tpu3d_torch.config import RegistrationConfig
from tpu3d_torch.types import FPFHFeatures, PointCloud, RegistrationResult

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cloud_arrays(rng, n=100, cap=128, normals=True):
    mask = np.arange(cap) < n
    return {
        "points": rng.normal(size=(cap, 3)).astype(np.float32),
        "mask": mask,
        "normals": rng.normal(size=(cap, 3)).astype(np.float32)
        if normals else None,
        "colors": None,
    }


@pytest.mark.parametrize("normals", [True, False])
def test_cloud_round_trip(rng, normals):
    arrays = _cloud_arrays(rng, normals=normals)
    cloud = carry.from_numpy(PointCloud, arrays, device="cpu")
    assert cloud.points.dtype == torch.float32 and cloud.mask.dtype == torch.bool
    back = carry.to_numpy(cloud)
    for k, v in arrays.items():
        if v is None:
            assert back[k] is None
        else:
            np.testing.assert_array_equal(back[k], v)


def test_features_and_result_round_trip(rng):
    feats = {
        "descriptors": rng.uniform(size=(64, 33)).astype(np.float32),
        "mask": rng.uniform(size=64) > 0.3,
    }
    f = carry.from_numpy(FPFHFeatures, feats, device="cpu")
    back = carry.to_numpy(f)
    np.testing.assert_array_equal(back["descriptors"], feats["descriptors"])
    np.testing.assert_array_equal(back["mask"], feats["mask"])

    res = {
        "transformation": rng.normal(size=(4, 4)).astype(np.float32),
        "fitness": np.float32(0.75),
        "rmse": np.float32(1e-3),
    }
    r = carry.from_numpy(RegistrationResult, res, device="cpu")
    assert r.fitness.shape == () and float(r.fitness) == 0.75
    back = carry.to_numpy(r)
    np.testing.assert_array_equal(back["transformation"], res["transformation"])
    assert back["rmse"] == res["rmse"]


def test_carry_from_jax_cloud(rng):
    """A JAX PointCloud crosses over field by field, via numpy."""
    from tpu3d.types import PointCloud as JaxPointCloud

    pts = rng.normal(size=(70, 3)).astype(np.float32)
    jc = JaxPointCloud.from_numpy(pts)
    tc = carry.from_numpy(
        PointCloud, {k: None if v is None else np.asarray(v)
                     for k, v in jc._asdict().items()}, device="cpu"
    )
    assert tc.capacity == jc.capacity == 128
    np.testing.assert_array_equal(tc.points.numpy(), np.asarray(jc.points))
    assert tc.count() == 70
    tp = PointCloud.from_numpy(pts, device="cpu")
    np.testing.assert_array_equal(tp.points.numpy(), tc.points.numpy())
    np.testing.assert_array_equal(tp.mask.numpy(), tc.mask.numpy())


def test_state_defaults_to_the_card(rng):
    """Entry points that make state put it on CUDA unless the caller asks
    for the CPU: without a card that is an error, never a silent CPU run."""
    import inspect

    for fn in (PointCloud.from_numpy, carry.from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    pts = rng.normal(size=(10, 3)).astype(np.float32)
    arrays = {"points": pts, "mask": np.ones(10, bool)}
    if torch.cuda.is_available():
        assert PointCloud.from_numpy(pts).points.is_cuda
        assert carry.from_numpy(PointCloud, arrays).points.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            PointCloud.from_numpy(pts)
        with pytest.raises((AssertionError, RuntimeError)):
            carry.from_numpy(PointCloud, arrays)


def test_config_defaults_match_jax():
    ours = dataclasses.asdict(RegistrationConfig())
    theirs = dataclasses.asdict(JaxRegistrationConfig())
    for k, v in ours.items():
        assert theirs[k] == v, k


def test_import_leaves_jax_out():
    code = (
        "import sys, tpu3d_torch, tpu3d_torch.carry, tpu3d_torch.build\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'tpu3d' or m.startswith('tpu3d.')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
    )
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _port_sources():
    root = os.path.join(_REPO, "tpu3d_torch")
    out = [os.path.join(_REPO, "chip_smoke.py")]
    for d, _, files in os.walk(root):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_no_module_of_the_port_imports_jax():
    """No module of tpu3d_torch/ and no part of chip_smoke.py imports jax,
    jaxlib or the JAX package, at the top or inside a function."""
    sources = _port_sources()
    assert len(sources) > 40
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                roots = {node.module.split(".")[0]}
            else:
                continue
            assert not roots & {"jax", "jaxlib", "tpu3d"}, (path, roots)


def test_search_indexes_round_trip(rng):
    """The JAX package's SlabIndex and GridIndex move into the port's
    types field by field (the JAX slab's extra sorted_points is left
    behind), and back."""
    import jax.numpy as jnp

    from tpu3d.ops.grid import build_grid
    from tpu3d.ops.slab import build_slab
    from tpu3d_torch.ops.grid import GridIndex
    from tpu3d_torch.ops.slab import SlabIndex

    pts = rng.uniform(-0.1, 0.1, (300, 3)).astype(np.float32)
    mask = np.arange(300) < 280
    for cls, jidx in ((SlabIndex, build_slab(jnp.asarray(pts),
                                             jnp.asarray(mask))),
                      (GridIndex, build_grid(jnp.asarray(pts),
                                             jnp.asarray(mask), 0.02))):
        moved = carry.from_numpy(cls, jidx, device="cpu")
        back = carry.to_numpy(moved)
        assert set(back) == set(cls._fields)
        for f in cls._fields:
            np.testing.assert_array_equal(back[f],
                                          np.asarray(getattr(jidx, f)))
