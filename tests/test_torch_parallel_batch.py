"""The instance batch over a mesh (``test_parallel.py``'s batch cases):
``shard_instances`` places the instance axis over 'inst'; ``register_batch``
on that batch gives the unplaced batch's results, and with the
('inst', 'shard') mesh each member registers sharded over its row, as the
JAX package's ``register_prepared_sharded`` registers that member on 2
devices (same inputs, its draw stream replayed); and a small dryrun on 4
CPU shards."""

import jax
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
from tpu3d.parallel import make_mesh as jax_make_mesh
from tpu3d.parallel.register_sharded import (
    register_prepared_sharded as jax_register_sharded,
)
from tpu3d.config import RegistrationConfig as JaxConfig
from tpu3d_torch.parallel import (
    make_mesh,
    register_batch,
    shard_instances,
    stack_clouds,
)
from tpu3d_torch.parallel.dryrun import dryrun_multichip
from tpu3d_torch.parallel.mesh import ShardedRows
from tpu3d_torch.types import FPFHFeatures
from torch_threads import one_torch_thread  # noqa: F401


def _batch(prepared, n):
    sd, td, sf, tf = prepared
    ts, tt, tsf, ttf = _to_torch(sd, td, sf, tf)
    shifts = [torch.tensor([0.004 * i, -0.002 * i, 0.001 * i])
              for i in range(n)]
    tb = stack_clouds([ts._replace(points=ts.points + s) for s in shifts])
    tfeat = FPFHFeatures(descriptors=torch.stack([tsf.descriptors] * n),
                         mask=torch.stack([tsf.mask] * n))
    return tb, tfeat, tt, ttf


def test_shard_instances_places_the_batch(prepared_4096):
    tb, tfeat, tt, ttf = _batch(prepared_4096, 4)
    mesh = make_mesh(("inst",), devices=["cpu"] * 4)
    sb, sfeat = shard_instances(tb, tfeat, mesh)
    assert isinstance(sb.points, ShardedRows) and sb.points.n_shards == 4
    assert sb.colors is None and isinstance(sfeat.mask, ShardedRows)
    assert torch.equal(sb.points.gather(), tb.points)
    kw = dict(ransac_max_iterations=2000, icp_max_iterations=10)
    ref_r, ref_c = register_batch(tb, tt, tfeat, ttf, VOXEL, **kw)
    got_r, got_c = register_batch(sb, tt, sfeat, ttf, VOXEL, **kw)
    for got, ref in ((got_r, ref_r), (got_c, ref_c)):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


def test_register_batch_on_a_2d_mesh_replays_jax(prepared_4096):
    """Each member sharded over its 'inst' row: the JAX package's sharded
    RANSAC + ICP of that member (same draws, 2 shards) within 1e-5."""
    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual CPU mesh (conftest default)")
    sd, td, sf, tf = prepared_4096
    tb, tfeat, tt, ttf = _batch(prepared_4096, 2)
    mesh = make_mesh(("inst", "shard"), shape=(2, 2), devices=["cpu"] * 4)
    sb, sfeat = shard_instances(tb, tfeat, mesh)
    kw = dict(ransac_max_iterations=3000, icp_max_iterations=20)
    got_r, got_c = register_batch(sb, tt, sfeat, ttf, VOXEL, mesh=mesh,
                                  draws=JaxDraws(42), **kw)
    assert got_r.transformation.shape == (2, 4, 4)
    jmesh = jax_make_mesh(("shard",), devices=jax.devices()[:2])
    cfg = JaxConfig(voxel_size=VOXEL, ransac_max_iterations=3000,
                    icp_max_iterations=20)
    for b in range(2):
        src = sd._replace(points=jnp.asarray(tb.points[b].numpy()))
        ref_r, ref_c = jax_register_sharded(src, td, sf, tf, cfg, jmesh)
        np.testing.assert_allclose(got_c.transformation[b].numpy(),
                                   np.asarray(ref_c.transformation),
                                   atol=1e-5)
        np.testing.assert_allclose(got_r.transformation[b].numpy(),
                                   np.asarray(ref_r.transformation),
                                   atol=1e-5)
        assert float(got_r.fitness[b]) > 0.8


def test_small_dryrun():
    """The dryrun's three phases on 4 CPU shards (2 x 2) at small rows."""
    facts = dryrun_multichip(4, device_type="cpu", inst_rows=4096,
                             n_big=16384, devices=["cpu"] * 4)
    assert facts["mesh"] == {"inst": 2, "shard": 2}
    assert facts["register"]["fitness"] > 0.9
