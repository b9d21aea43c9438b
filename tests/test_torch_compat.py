"""The port's reference-shaped facade (tpu3d_torch/compat.py) end to end,
mirroring tests/test_compat.py on CPU tensors, and the facade's steps
against the JAX facade's on the same cloud."""

import numpy as np

from tpu3d.compat import Registration as JaxRegistration
from tpu3d.types import PointCloud as JaxCloud
from tpu3d_torch.compat import Registration
from tpu3d_torch.types import PointCloud
from torch_threads import one_torch_thread  # noqa: F401


def _surface(rng):
    xy = rng.uniform(-0.15, 0.15, size=(300, 2)).astype(np.float32)
    z = 0.7 + 0.05 * np.sin(15 * xy[:, 0]) * np.cos(12 * xy[:, 1])
    return np.column_stack([xy, z]).astype(np.float32)


def test_reference_api_surface_roundtrip(rng):
    tgt_pts = _surface(rng)
    R = np.array([[0.995, 0.0998, 0], [-0.0998, 0.995, 0], [0, 0, 1]],
                 np.float32)
    t = np.array([0.01, -0.02, 0.01], np.float32)
    src_pts = ((tgt_pts - t) @ R).astype(np.float32)

    voxel = 0.01
    src = Registration.voxelDownsample(
        PointCloud.from_numpy(src_pts, device="cpu"), voxel)
    tgt = Registration.voxelDownsample(
        PointCloud.from_numpy(tgt_pts, device="cpu"), voxel)
    src = Registration.estimateNormals(src, 30)
    tgt = Registration.estimateNormals(tgt, 30)
    sf = Registration.computeFPFH(src, voxel * 5)
    tf = Registration.computeFPFH(tgt, voxel * 5)
    coarse = Registration.ransacRegistration(src, tgt, sf, tf, voxel,
                                             max_iterations=4096)
    refined = Registration.icpRefine(src, tgt, coarse.transformation,
                                     voxel * 2.0, max_iterations=30)
    T = refined.transformation.numpy()
    assert float(refined.fitness) > 0.7
    np.testing.assert_allclose(T[:3, :3], R, atol=0.03)
    np.testing.assert_allclose(T[:3, 3], t, atol=0.015)
    # A numpy start pose is accepted as well.
    again = Registration.icpRefine(src, tgt, T, voxel * 2.0,
                                   max_iterations=30)
    assert float(again.fitness) > 0.7


def test_steps_match_the_jax_facade(rng):
    """Downsample and normals as the JAX facade gives them (|cos| ≥
    0.9999), on the same cloud."""
    pts = _surface(rng)
    jd = JaxRegistration.estimateNormals(
        JaxRegistration.voxelDownsample(JaxCloud.from_numpy(pts), 0.01), 30)
    td = Registration.estimateNormals(Registration.voxelDownsample(
        PointCloud.from_numpy(pts, device="cpu"), 0.01), 30)
    mask = np.asarray(jd.mask)
    np.testing.assert_array_equal(td.mask.numpy(), mask)
    np.testing.assert_allclose(td.points.numpy(), np.asarray(jd.points),
                               atol=1e-6)
    cos = np.abs((td.normals.numpy() * np.asarray(jd.normals)).sum(1))
    assert cos[mask].min() >= 0.9999


def test_load_reference_model(rng, tmp_path):
    cloud = Registration.loadReferenceModel("/nonexistent/m.ply",
                                            device="cpu")
    assert cloud.capacity == 0
    from tpu3d_torch.models.ply import save_ply

    pts = rng.normal(size=(50, 3)).astype(np.float32)
    save_ply(str(tmp_path / "m.ply"), pts)
    cloud = Registration.loadReferenceModel(str(tmp_path / "m.ply"),
                                            device="cpu")
    assert cloud.count() == 50
    np.testing.assert_allclose(cloud.points.numpy()[:50], pts, atol=1e-4)
