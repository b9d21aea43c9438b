"""The port's SE(3) helpers that the pipeline and the gather sampler use
(``invert_transform``, ``matrix_to_rpy_zyx``, ``kabsch_quat``) against the
JAX package's on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from tpu3d.ops import transforms as jt
from tpu3d_torch.ops import transforms as tt


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], -2).astype(np.float32)


def test_invert_transform_matches_jax(rng):
    T = np.tile(np.eye(4, dtype=np.float32), (50, 1, 1))
    T[:, :3, :3] = _rotations(rng, 50)
    T[:, :3, 3] = rng.uniform(-1, 1, (50, 3))
    got = tt.invert_transform(torch.from_numpy(T)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jt.invert_transform(jnp.asarray(T))), atol=1e-6)
    np.testing.assert_allclose(got @ T, np.tile(np.eye(4), (50, 1, 1)),
                               atol=1e-5)


def test_matrix_to_rpy_matches_jax(rng):
    R = _rotations(rng, 200)
    # Gimbal lock both ways: R[2, 0] = ∓1 takes the other branch.
    c, s = np.cos(0.7), np.sin(0.7)
    for sgn in (1.0, -1.0):
        R = np.concatenate([R, np.array(
            [[[0, s, sgn * c], [0, c, -sgn * s], [-sgn, 0, 0]]], np.float32)])
    got = tt.matrix_to_rpy_zyx(torch.from_numpy(R)).numpy()
    ref = np.asarray(jt.matrix_to_rpy_zyx(jnp.asarray(R)))
    np.testing.assert_allclose(got, ref, atol=2e-6)
    np.testing.assert_array_equal(got[-2:, 2], 0.0)


@pytest.mark.parametrize("degenerate", [False, True])
def test_kabsch_quat_matches_jax(rng, degenerate):
    src = rng.uniform(-0.2, 0.2, (300, 3, 3)).astype(np.float32)
    if degenerate:
        src[:, 1:] = src[:, :1]  # coincident: the identity fallback
    R = _rotations(rng, 300)
    tgt = (np.einsum("hij,hkj->hki", R, src)
           + rng.uniform(-0.1, 0.1, (300, 1, 3))).astype(np.float32)
    Rg, tg = tt.kabsch_quat(torch.from_numpy(src), torch.from_numpy(tgt))
    Rj, tj = jt.kabsch_quat(jnp.asarray(src), jnp.asarray(tgt))
    # XLA contracts the Newton and adjugate products into FMAs on the CPU,
    # which moves the eigenvector of an ill-conditioned (near-collinear)
    # random triple by up to ~1e-4; well-conditioned ones agree to ~1e-6.
    np.testing.assert_allclose(Rg.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tg.numpy(), np.asarray(tj), atol=2e-5)
    # Always a proper rotation: the renormalised quaternion.
    det = np.linalg.det(Rg.numpy().astype(np.float64))
    np.testing.assert_allclose(det, 1.0, atol=1e-5)
    if degenerate:
        np.testing.assert_array_equal(Rg.numpy(),
                                      np.tile(np.eye(3), (300, 1, 1)))
    else:
        np.testing.assert_allclose(Rg.numpy(), R, atol=1e-4)


@pytest.mark.parametrize("weighted,reflect", [(False, False), (True, False),
                                              (False, True)])
def test_kabsch_matches_jax(rng, weighted, reflect):
    """The batched weighted SVD Kabsch against the JAX package's, on
    (8, 50)-point batches; ``reflect`` mirrors the targets, so the
    reflection fix decides every rotation."""
    B, n = 8, 50
    src = rng.uniform(-0.3, 0.3, (B, n, 3)).astype(np.float32)
    R = _rotations(rng, B)
    tgt = (np.einsum("bij,bkj->bki", R, src)
           + rng.uniform(-0.1, 0.1, (B, 1, 3))
           + rng.normal(scale=1e-3, size=(B, n, 3))).astype(np.float32)
    if reflect:
        tgt[..., 2] *= -1.0
    w = (rng.uniform(0.0, 1.0, (B, n)).astype(np.float32)
         if weighted else None)
    tw = None if w is None else torch.from_numpy(w)
    jw = None if w is None else jnp.asarray(w)
    Rg, tg = tt.kabsch(torch.from_numpy(src), torch.from_numpy(tgt), tw)
    Rj, tj = jt.kabsch(jnp.asarray(src), jnp.asarray(tgt), jw)
    np.testing.assert_allclose(Rg.numpy(), np.asarray(Rj), atol=2e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(tj), atol=2e-5)
    det = np.linalg.det(Rg.numpy().astype(np.float64))
    np.testing.assert_allclose(det, 1.0, atol=1e-5)
    if not reflect:
        np.testing.assert_allclose(Rg.numpy(), R, atol=1e-2)
    from tpu3d_torch.ops import kabsch
    assert kabsch is tt.kabsch
