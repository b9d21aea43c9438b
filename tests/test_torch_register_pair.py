"""End-to-end port parity: ``tpu3d_torch.register_pair`` against the JAX
``register_pair`` on the bench fixture, with the JAX draw stream replayed,
and the routes the port does not hold yet."""

import jax
import numpy as np
import pytest

import tpu3d
import tpu3d_torch
from bench import make_pair

VOXEL = 0.005


def jax_draws(seed):
    """The JAX package's per-(chunk, epoch) triples (ops/ransac.py)."""
    hyp_key = jax.random.fold_in(jax.random.PRNGKey(seed), 7)

    def draw(c, e):
        k = jax.random.fold_in(jax.random.fold_in(hyp_key, c), e)
        u = np.asarray(jax.random.randint(k, (3,), 0, 1 << 30))
        return int(u[0]), int(u[1]), int(u[2])

    return draw


def _gate(T, R, t):
    """bench.py's quality gate."""
    return (np.abs(T[:3, :3] - R).max() < 0.02
            and np.abs(T[:3, 3] - t).max() < 0.005)


@pytest.mark.parametrize("n,capacity", [(4096, 4096), (2048, 2048)])
def test_register_pair_matches_jax(n, capacity):
    src, tgt, R, t = make_pair(n, voxel=VOXEL)
    iters = 30000
    ref, ref_coarse = tpu3d.register_pair(
        tpu3d.PointCloud.from_numpy(src), tpu3d.PointCloud.from_numpy(tgt),
        tpu3d.RegistrationConfig(voxel_size=VOXEL,
                                 ransac_max_iterations=iters),
    )
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=VOXEL,
                                         ransac_max_iterations=iters)
    s = tpu3d_torch.PointCloud.from_numpy(src)
    d = tpu3d_torch.registration.downsample_bucketed(s, cfg)
    assert d.capacity == capacity
    got, coarse = tpu3d_torch.register_pair(
        s, tpu3d_torch.PointCloud.from_numpy(tgt), cfg,
        draws=jax_draws(cfg.ransac_seed),
    )
    T = got.transformation.numpy()
    T_ref = np.asarray(ref.transformation)
    assert np.isfinite(T).all() and T.shape == (4, 4)
    np.testing.assert_allclose(T, T_ref, atol=1e-4)
    assert abs(float(got.fitness) - float(ref.fitness)) <= 0.005
    # Descriptors agree to ~1e-6, which reorders a few near-tied
    # correspondences, so the coarse winner may differ; ICP converges to
    # the same pose from either.
    assert float(coarse.fitness) > 0.3 and float(ref_coarse.fitness) > 0.3
    assert _gate(T, R, t) and _gate(T_ref, R, t)


def test_unported_routes_raise():
    src, tgt, _, _ = make_pair(600, voxel=VOXEL)
    s = tpu3d_torch.PointCloud.from_numpy(src)
    g = tpu3d_torch.PointCloud.from_numpy(tgt)
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=VOXEL)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tpu3d_torch.register_pair(s, g, cfg, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tpu3d_torch.register_pair(
            s, g, tpu3d_torch.RegistrationConfig(voxel_size=VOXEL,
                                                 prepare_mode="sparse"))
    big, _, _, _ = make_pair(20000, voxel=VOXEL)
    with pytest.raises(NotImplementedError, match="fused prepare"):
        tpu3d_torch.register_pair(
            tpu3d_torch.PointCloud.from_numpy(big), g,
            tpu3d_torch.RegistrationConfig(voxel_size=0.0005))
