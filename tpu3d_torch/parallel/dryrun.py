"""One full multi-device step over a mesh: the counterpart of
``dryrun_multichip`` (``__graft_entry__.py``).

Three phases on a ('inst', 'shard') mesh of ``n_devices`` devices
(2 × n/2 when n ≥ 4 and even, else n × 1):

  1. probes: the sharded top-1 NN against a 512-row target and three
     sharded ICP iterations;
  2. the 2-D phase (``_dryrun_batch_2d``): ``inst`` instances of
     ``inst_rows`` rows each, placed over 'inst' by ``shard_instances``,
     registered by ``register_batch`` with each instance's RANSAC and ICP
     sharded over its row's 'shard' devices; every instance must recover
     its own translation;
  3. the public-API sharded register (``register_pair_sharded``, the
     radius-aware halo) at ``n_big`` rows on a rotated and translated
     source, both prepares distributed, the rotation recovered.

Smaller ``inst_rows``/``n_big`` keep the sheets' density (their extent
shrinks with them).

    python -c "import tpu3d_torch.parallel.dryrun as d; d.dryrun_multichip(4)"

runs it on the card; with fewer devices installed than ``n_devices``,
the first one is listed that many times (a virtual mesh).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3d_torch.config import RegistrationConfig
from tpu3d_torch.ops.fused_features import fused_prepare_features
from tpu3d_torch.ops.normals import estimate_normals
from tpu3d_torch.parallel.batched import (
    register_batch,
    shard_instances,
    stack_clouds,
)
from tpu3d_torch.parallel.icp_sharded import icp_refine_sharded
from tpu3d_torch.parallel.mesh import make_mesh, visible_devices
from tpu3d_torch.parallel.register_sharded import register_pair_sharded
from tpu3d_torch.parallel.sharded_nn import nearest_neighbor_sharded
from tpu3d_torch.types import FPFHFeatures, PointCloud


def _surface(rng, n, half, voxel):
    """The dryrun's two-frequency bumpy sheet over [-half, half]²
    (``__graft_entry__.py``'s: 65,536 rows a square metre)."""
    xy = rng.uniform(-half, half, size=(n, 2)).astype(np.float32)
    r5 = 5.0 * voxel
    w1, w2 = 1.2 / r5, 0.45 / r5
    z = (0.7
         + 2.5 * voxel * np.sin(w1 * xy[:, 0]) * np.cos(0.8 * w1 * xy[:, 1])
         + 6.0 * voxel * np.cos(w2 * xy[:, 0]) * np.cos(1.1 * w2 * xy[:, 1]))
    return np.column_stack([xy, z]).astype(np.float32)


def _rotation(aa) -> np.ndarray:
    aa = np.asarray(aa, np.float64)
    th = np.linalg.norm(aa)
    k = aa / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(th) * K
            + (1 - np.cos(th)) * K @ K).astype(np.float32)


def dryrun_multichip(n_devices: int, device_type: str = "cuda",
                     inst_rows: int = 16384, n_big: int = 65536,
                     devices=None) -> dict:
    """Run the three phases (see the module docstring) and return their
    facts: mesh shape, the 2-D phase's mean fitness and the 64k register's
    fitness and errors. Raises AssertionError when a phase fails."""
    if devices is None:
        devices = visible_devices(device_type)
        if len(devices) < n_devices:
            devices = [devices[0]] * n_devices
    devices = list(devices)[:n_devices]
    if n_devices >= 4 and n_devices % 2 == 0:
        shape = (n_devices // 2, 2)
    else:
        shape = (n_devices, 1)
    mesh = make_mesh(("inst", "shard"), shape=shape, devices=devices)
    n_inst, n_shard = shape
    dev = devices[0]

    # ---- probes: the sharded NN and three sharded ICP iterations.
    cap, tgt_cap, voxel = 256, 512, 0.01
    if tgt_cap % n_shard:
        tgt_cap = n_shard * (-(-tgt_cap // n_shard))
    rng = np.random.default_rng(1)
    tgt = estimate_normals(PointCloud.from_numpy(
        _surface(rng, tgt_cap, 0.15, voxel), capacity=tgt_cap, device=dev),
        k=10)
    src0 = PointCloud.from_numpy(
        _surface(np.random.default_rng(10), cap, 0.15, voxel), capacity=cap,
        device=dev)
    idx, d2 = nearest_neighbor_sharded(src0.points, tgt.points, tgt.mask,
                                       mesh, axis="shard")
    assert idx.shape == (cap,) and bool((d2 >= 0).all())
    res = icp_refine_sharded(src0, tgt, torch.eye(4, device=dev), 0.05,
                             mesh=mesh, axis="shard", max_iterations=3,
                             point_to_plane=True)
    assert bool(torch.isfinite(res.transformation).all())

    fit_2d = _dryrun_batch_2d(mesh, max(n_inst, 2), inst_rows, dev)
    fit_big, r_err, t_err = _dryrun_sharded_register(
        make_mesh(("shard",), devices=devices), n_big, dev)
    facts = {"mesh": dict(zip(("inst", "shard"), shape)),
             "batch_2d": {"instances": max(n_inst, 2), "rows": inst_rows,
                          "mean_fitness": fit_2d},
             "register": {"rows": n_big, "fitness": fit_big,
                          "rot_err": r_err, "trans_err": t_err}}
    print(f"dryrun_multichip OK: {facts}")
    return facts


def _dryrun_batch_2d(mesh, n_inst: int, n_rows: int, dev) -> float:
    """Instances over 'inst', each one's RANSAC and ICP sharded over its
    row's 'shard' devices. The sources are translations of the target, so
    one prepare serves them all (normals and FPFH ignore translation).
    Returns the mean refined fitness."""
    voxel = 0.002
    r5 = float(np.float32(5.0 * voxel))
    tgt_np = _surface(np.random.default_rng(11), n_rows,
                      0.25 * np.sqrt(n_rows / 16384), voxel)
    tgt, tf = fused_prepare_features(
        PointCloud.from_numpy(tgt_np, capacity=n_rows, device=dev), r5)
    t_trues = np.stack([np.float32([0.011, -0.007, 0.009]) * (1.0 + 0.3 * i)
                        for i in range(n_inst)])
    srcs = [tgt._replace(points=tgt.points - torch.from_numpy(
        t_trues[i]).to(dev)) for i in range(n_inst)]
    batch = stack_clouds(srcs)
    fbatch = FPFHFeatures(descriptors=torch.stack([tf.descriptors] * n_inst),
                          mask=torch.stack([tf.mask] * n_inst))
    if n_inst % mesh.shape["inst"] == 0:
        batch, fbatch = shard_instances(batch, fbatch, mesh, "inst")
    refined, _ = register_batch(
        batch, tgt, fbatch, tf, voxel,
        ransac_max_iterations=4096, icp_max_iterations=3,
        icp_distance_factor=2.0, mesh=mesh)
    T = refined.transformation.cpu().numpy()
    assert T.shape == (n_inst, 4, 4) and np.isfinite(T).all()
    err = float(np.abs(T[:, :3, 3] - t_trues).max())
    assert err < 0.004, (err, T[:, :3, 3], t_trues)
    return float(refined.fitness.mean())


def _dryrun_sharded_register(mesh1, n: int, dev):
    """``register_pair_sharded`` on a rotated + translated source of ``n``
    rows with the production 100k RANSAC budget: both prepares must
    distribute and the pose must come back. Returns (fitness, rotation
    error, translation error)."""
    voxel = 0.002
    tgt_np = _surface(np.random.default_rng(3), n,
                      0.5 * np.sqrt(n / 65536), voxel)
    R_true = _rotation([0.05, -0.035, 0.06])
    t_true = np.float32([0.012, -0.009, 0.01])
    src_np = ((tgt_np - t_true) @ R_true).astype(np.float32)
    cfg = RegistrationConfig(voxel_size=voxel, ransac_max_iterations=100000,
                             icp_max_iterations=5, icp_distance_factor=2.0,
                             max_points=n)
    refined, coarse, info = register_pair_sharded(
        PointCloud.from_numpy(src_np, capacity=n, device=dev),
        PointCloud.from_numpy(tgt_np, capacity=n, device=dev),
        cfg, mesh1, return_info=True)
    assert info["mode"] == "fused", info
    assert info["src_prepare_distributed"], info
    assert info["tgt_prepare_distributed"], info
    T = refined.transformation.cpu().numpy()
    assert np.isfinite(T).all()
    r_err = float(np.abs(T[:3, :3] - R_true).max())
    t_err = float(np.abs(T[:3, 3] - t_true).max())
    assert r_err < 0.01, (r_err, T[:3, :3], R_true)
    assert t_err < 0.004, (t_err, T[:3, 3], t_true)
    assert float(coarse.fitness) > 0.2, float(coarse.fitness)
    return float(refined.fitness), r_err, t_err

