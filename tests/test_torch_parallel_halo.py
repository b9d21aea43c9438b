"""``prepare_features_sharded`` on an 8-shard CPU mesh
(``test_register_sharded.py``'s radius-aware halo case): the halo sized
from the cloud's density distributes where the row-count default would
not, and a halo that cannot span 3·radius falls back to the lead device's
prepare and says so."""

import numpy as np
import torch

from test_torch_parallel_register import _cloud, cpu8  # noqa: F401
from tpu3d_torch.config import RegistrationConfig
from tpu3d_torch.parallel.register_sharded import prepare_features_sharded
from torch_threads import one_torch_thread  # noqa: F401


def test_prepare_sharded_default_halo_is_radius_aware(cpu8):
    """3·r5 exceeds the row-count default halo, the radius-aware one
    spans it: the prepare must distribute."""
    rng = np.random.default_rng(7)
    n, voxel = 16384, 7e-4
    r5 = 5.0 * voxel
    xy = rng.uniform(-0.075, 0.075, size=(n, 2)).astype(np.float32)
    w = 1.1 / r5
    z = 0.7 + 1.2 * r5 * np.sin(w * xy[:, 0]) * np.cos(0.8 * w * xy[:, 1])
    cloud = _cloud(np.column_stack([xy, z]).astype(np.float32), capacity=n)
    out, feat, distributed = prepare_features_sharded(
        cloud, RegistrationConfig(voxel_size=voxel), cpu8)
    assert distributed
    v = out.mask
    assert torch.isfinite(out.normals[v]).all()
    assert float(feat.descriptors[v].sum()) > 0


def test_prepare_sharded_falls_back_loudly(cpu8, capsys):
    """A halo that cannot span 3r: the lead device's prepare, said so."""
    rng = np.random.default_rng(8)
    pts = rng.uniform(-0.05, 0.05, size=(1024, 3)).astype(np.float32)
    pts[:, 0] = 0.01  # degenerate x
    out, feat, distributed = prepare_features_sharded(
        _cloud(pts, capacity=1024), RegistrationConfig(voxel_size=0.004),
        cpu8, halo=8)
    assert not distributed
    assert "falling back" in capsys.readouterr().out
    assert torch.isfinite(out.normals[out.mask]).all()
