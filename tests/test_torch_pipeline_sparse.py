"""The port's pipeline on the sparse-prepare arm against the JAX package's
(``tests/test_pipeline.py``'s sparse routing fixture, on a smaller bumpy
frame): routing and the batched group, with JAX's RANSAC draw stream
replayed. The escalation paths are in
``tests/test_torch_pipeline_escalation.py``."""

import numpy as np
import pytest
import torch

from test_pipeline import _bumpy_frame
from test_torch_ransac import JaxDraws
from torch_threads import one_torch_thread  # noqa: F401
from tpu3d.config import PipelineConfig as JaxConfig
from tpu3d.pipeline.pipeline import Pipeline as JaxPipeline
from tpu3d.registration import prepare_features as jax_prepare_features
from tpu3d_torch.config import PipelineConfig
from tpu3d_torch.pipeline import pipeline as port_pipeline
from tpu3d_torch.registration import prepare_features

SCALE = 10000.0


def _config(cfg, escalate):
    cfg.use_camera = cfg.use_robot = False
    cfg.visualization = "none"
    cfg.camera_extrinsics = np.eye(4, dtype=np.float32)
    cfg.depth.scale_to_meters = SCALE
    cfg.registration.voxel_size = 0.008
    cfg.registration.prepare_mode = "sparse"
    cfg.registration.ransac_max_iterations = 1500
    cfg.registration.icp_max_iterations = 20
    if escalate:
        cfg.registration.sparse_escalate_fitness = 2.0  # always escalate
    return cfg


@pytest.fixture(scope="module")
def frame():
    z, K = _bumpy_frame(w=160, h=120)
    return (z * SCALE).astype(np.float32), K


def _both(frame, escalate, monkeypatch):
    """JAX's and the port's pipeline in the run-wide 'fused' mode (a
    fused-scale reference model), one self-registration instance each, and
    the count of the port's sparse prepares."""
    depth, K = frame
    jp = JaxPipeline(_config(JaxConfig(), escalate), sleep_fn=lambda s: None)
    cfg = _config(PipelineConfig(), escalate)
    cfg.use_gpu = False
    tp = port_pipeline.Pipeline(cfg, sleep_fn=lambda s: None)
    tp._draws = JaxDraws(cfg.registration.ransac_seed)
    jp._neighbor_mode = tp._neighbor_mode = "fused"
    sparse_runs = []
    real = port_pipeline.fused_prepare_sparse

    def counted(*a, **k):
        sparse_runs.append(1)
        return real(*a, **k)

    monkeypatch.setattr(port_pipeline, "fused_prepare_sparse", counted)
    jprep = jp._prepare_instance_inner(None, depth, None, K, 0)
    tprep = tp._prepare_instance_inner(None, depth, None, K, 0)
    assert jprep[1] is None and tprep[1] is None, "descriptors not deferred"
    jref = jax_prepare_features(jprep[0], jp.config.registration, "fused")
    tref = prepare_features(tprep[0], cfg.registration, "fused")
    return (jp, jprep, jref), (tp, tprep, tref), sparse_runs


def _assert_same(j_poses, t_poses, jp, tp, n):
    for a, b in zip(j_poses, t_poses):
        assert b is not None and np.all(np.isfinite(b))
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    for a, b in zip(jp.instance_results, tp.instance_results):
        assert abs(b["fitness"] - a["fitness"]) * n <= 1.0 + 1e-3
        np.testing.assert_allclose(b["T_world_object"][:3, :3], np.eye(3),
                                   atol=0.05)


def test_sparse_routing_batches_like_jax(frame, monkeypatch):
    """Two same-capacity sparse instances register as one batch, RANSAC on
    the subset views and ICP on the full clouds, at JAX's poses; without
    the run-wide 'fused' mode the knob stays inert."""
    (jp, jprep, jref), (tp, tprep, tref), runs = _both(frame, False,
                                                       monkeypatch)
    j_poses = jp._register_instances([jprep, jprep], *jref)
    t_poses = tp._register_instances([tprep, tprep], *tref)
    assert tp._batched_groups == 1 and tp._degraded == 0
    assert len(runs) == 2
    _assert_same(j_poses, t_poses, jp, tp, tprep[0].count())

    tp._neighbor_mode = "auto"
    depth, K = frame
    prep2 = tp._prepare_instance_inner(None, depth, None, K, 1)
    assert prep2 is not None and prep2[1] is not None
    assert isinstance(prep2[1].descriptors, torch.Tensor)
