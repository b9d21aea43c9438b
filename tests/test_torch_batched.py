"""``register_batch`` against the JAX package's ``vmap``: the same stacked
instances (prepared once by JAX, so both sides see identical inputs) and
JAX's RANSAC draw stream give the same stacked results."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ransac import (  # noqa: F401
    VOXEL,
    JaxDraws,
    _to_torch,
    prepared_4096,
)
from torch_threads import one_torch_thread  # noqa: F401
from tpu3d.parallel.batched import register_batch as jax_register_batch
from tpu3d.parallel.batched import stack_clouds as jax_stack
from tpu3d.types import FPFHFeatures as JaxFeatures
from tpu3d.types import PointCloud as JaxCloud
from tpu3d_torch.parallel.batched import register_batch, stack_clouds
from tpu3d_torch.types import FPFHFeatures


def _moved(cloud, angle, shift):
    """The cloud under a rotation about z and a shift (normals rotated)."""
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    pts = np.asarray(cloud.points) @ R.T + np.float32(shift)
    return JaxCloud(points=jnp.asarray(pts), mask=cloud.mask,
                    normals=jnp.asarray(np.asarray(cloud.normals) @ R.T))


@pytest.mark.parametrize("views", [False, True])
def test_register_batch_matches_vmap(prepared_4096, views):
    sd, td, sf, tf = prepared_4096
    clouds = [sd, _moved(sd, 0.05, [0.01, -0.004, 0.002])]
    jb = jax_stack(clouds)
    jf = JaxFeatures(descriptors=jnp.stack([sf.descriptors] * 2),
                     mask=jnp.stack([sf.mask] * 2))
    kw = dict(ransac_max_iterations=3000, icp_max_iterations=30)
    ref_r, ref_c = jax_register_batch(jb, td, jf, tf, VOXEL,
                                      ransac_sources=jb if views else None,
                                      **kw)

    parts = [_to_torch(c, td, sf, tf) for c in clouds]
    tb = stack_clouds([p[0] for p in parts])
    tfeat = FPFHFeatures(descriptors=torch.stack([p[2].descriptors
                                                  for p in parts]),
                         mask=torch.stack([p[2].mask for p in parts]))
    got_r, got_c = register_batch(
        tb, parts[0][1], tfeat, parts[0][3], VOXEL,
        ransac_sources=tb if views else None, draws=JaxDraws(42), **kw)

    n = int(np.asarray(sd.mask).sum())
    for got, ref in ((got_r, ref_r), (got_c, ref_c)):
        assert got.transformation.shape == (2, 4, 4)
        np.testing.assert_allclose(got.transformation.numpy(),
                                   np.asarray(ref.transformation), atol=1e-5)
        np.testing.assert_allclose(got.fitness.numpy() * n,
                                   np.asarray(ref.fitness) * n, atol=1.0)
    assert float(got_r.fitness.min()) > 0.5
