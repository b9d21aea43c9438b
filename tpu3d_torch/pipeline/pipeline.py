"""Pipeline orchestrator: capture → segment → register → pick.

Counterpart of ``tpu3d/pipeline/pipeline.py``. Stage structure and
degrade-don't-crash behaviour mirror Pipeline::run (src/pipeline.cpp:
183-380) and Pipeline::processInstance (:25-150): an instance whose
prepare or registration raises is reported and skipped (on the card a
failed ICP included), a failed ICP on CPU state is retried, and a low
fitness is warned about but the pose is still used. Per-instance prepare
fans out over a host thread pool (pipeline.cpp:321-339); instances that
share a capacity bucket register as one group, member by member. A
reference model read from a file is read and downsampled once and kept
between runs while the file, the settings and the device stay the same.

``use_gpu`` puts every tensor on the card (``cuda``) or, when false, on
the CPU, where each kernel's plain version runs. A ``parallel:`` block
that resolves to a mesh (``parallel_mesh`` over the devices of that type)
routes the reference model's prepare, every instance's dense prepare and
every registration through the distributed stack
(``parallel/register_sharded.py``), with the sparse arm's escalation
sharded too, and turns the capacity-group fan-out off, as in the JAX
package. A low-fitness member of a sparse group escalates from its own
result instead of re-running the sparse arm first.
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from tpu3d_torch.config import PipelineConfig
from tpu3d_torch.io.robot import Robot
from tpu3d_torch.io.segmentation import get_masks, resize_mask_nearest
from tpu3d_torch.models.ply import load_ply
from tpu3d_torch.models.procedural import (
    generate_box_mask,
    generate_reference_grid,
    generate_scene,
)
from tpu3d_torch.ops.deproject import deproject
from tpu3d_torch.ops.depth import bilateral_filter, depth_preprocess
from tpu3d_torch.ops.fused_features import fused_prepare_sparse
from tpu3d_torch.ops.icp import icp_refine
from tpu3d_torch.ops.ransac import ransac_registration, with_target_operand
from tpu3d_torch.ops.transforms import invert_transform
from tpu3d_torch.parallel.register_sharded import (
    parallel_mesh,
    prepare_features_sharded,
    register_prepared_sharded,
)
from tpu3d_torch.pipeline.dedup import filter_duplicates
from tpu3d_torch.registration import (
    downsample_bucketed,
    prepare_features,
    resolve_neighbor_mode,
    sparse_prepare_active,
    two_stage_opt,
)
from tpu3d_torch.types import PointCloud, RegistrationResult
from tpu3d_torch.utils.profiling import handoff, host_read, span, spanned
from tpu3d_torch.utils.profiling import count as count_event
from tpu3d_torch.viz.viewer import SceneViewer


class Pipeline:
    def __init__(self, config: PipelineConfig, sleep_fn=time.sleep):
        self.config = config
        self.viewer: Optional[SceneViewer] = None
        self._sleep_fn = sleep_fn
        self.waypoints: List[np.ndarray] = []  # result of the last run()
        self.instance_results: List[dict] = []  # per-instance fitness/rmse/T
        self._forced_K: Optional[np.ndarray] = None  # test hook: override K
        self._draws = None  # test hook: replayed RANSAC draw stream
        # One descriptor variant for the whole run (set when the reference
        # model is prepared) so instance clouds never mix fused and gather
        # FPFH against the model's.
        self._neighbor_mode: str = "auto"
        # The downsampled reference model read from a file, kept between
        # runs: (key, cloud); _reference_model.
        self._reference: Optional[tuple] = None
        # Diagnostic counters: ICP runs retried on CPU state, and instances
        # that raised and were skipped.
        self._host_icp_retries = 0
        self._degraded = 0
        self._batched_groups = 0
        self.device = torch.device("cuda" if config.use_gpu else "cpu")
        # Multi-device routing (the `parallel:` block): with a mesh, every
        # registration runs the distributed stack. The count is a
        # diagnostic hook.
        self._mesh = parallel_mesh(config.parallel, self.device.type)
        self._sharded_registrations = 0
        print(
            f"Pipeline created (threads={config.num_threads},"
            f" accelerator={'on' if config.use_gpu else 'off'}"
            + (f", mesh={self._mesh.devices.size}x'shard'"
               if self._mesh is not None else "")
            + ")"
        )

    # ---------------------------------------------------------------- stage 4
    def process_instance(
        self, mask, depth_raw, rgb, K, ref_cloud, ref_features, instance_id
    ) -> Optional[np.ndarray]:
        t0 = time.perf_counter()
        print(f"\n--- Processing instance {instance_id} ---")
        prep = self._prepare_instance_inner(mask, depth_raw, rgb, K,
                                            instance_id)
        if prep is None:
            return None
        return self._register_instance_inner(
            prep[0], prep[1], ref_cloud, ref_features, instance_id, t0
        )

    @spanned("pipeline.prepare_instance")
    def prepare_instance(
        self, mask, depth_raw, rgb, K, instance_id
    ) -> Optional[tuple]:
        """Per-instance prep up to FPFH: mask → depth → cloud →
        (downsampled cloud, features). Runs on pool threads."""
        print(f"\n--- Preparing instance {instance_id} ---")
        return self._prepare_instance_inner(mask, depth_raw, rgb, K,
                                            instance_id)

    def _prepare_instance_inner(
        self, mask, depth_raw, rgb, K, instance_id
    ) -> Optional[tuple]:
        cfg = self.config
        dev = self.device
        try:
            if mask is not None and mask.shape != depth_raw.shape:
                mask = resize_mask_nearest(mask, *depth_raw.shape)

            depth_m = depth_preprocess(
                torch.from_numpy(np.asarray(depth_raw, np.float32)).to(dev),
                None if mask is None else torch.from_numpy(
                    np.ascontiguousarray(mask)).to(dev),
                cfg.depth.scale_to_meters,
                apply_mask=cfg.segmentation.apply_mask,
            )
            if cfg.depth.bilateral_filter:
                depth_m = bilateral_filter(
                    depth_m,
                    cfg.depth.bilateral_sigma_spatial,
                    cfg.depth.bilateral_sigma_range,
                )
            if host_read("pipeline.depth_count", (depth_m > 0).sum(),
                         int) == 0:
                print(f"Instance {instance_id}: empty depth after masking")
                return None

            cloud = deproject(
                depth_m,
                None if rgb is None else torch.from_numpy(
                    np.ascontiguousarray(rgb)).to(dev),
                torch.from_numpy(np.asarray(K, np.float32)),
                cfg.depth.clipping_max,
            )
            n_pts = host_read("pipeline.count", cloud.mask.sum(), int)
            if n_pts == 0:
                print(f"Instance {instance_id}: empty point cloud")
                return None
            print(f"Instance {instance_id}: {n_pts} points")

            down = downsample_bucketed(
                cloud,
                cfg.registration,
                capacity=cfg.registration.max_points or None,
            )
            # registration.prepare_mode: the sparse query-subset source
            # prepare runs at registration time, only where RANSAC reads
            # descriptors; gated on the run-wide mode being 'fused' so
            # subset descriptors never meet a gather-mode model.
            if self._neighbor_mode == "fused" and sparse_prepare_active(
                cfg.registration, self._neighbor_mode, down
            ):
                return (down, None)
            if self._mesh is not None and self._neighbor_mode == "fused":
                c, f, _ = self._prepare_sharded(down)
                return (c, f)
            return prepare_features(down, cfg.registration,
                                    self._neighbor_mode)
        except Exception as e:  # degrade like pipeline.cpp:146-149
            print(f"Instance {instance_id} prepare error: {e}")
            self._degraded += 1
            return None

    @spanned("pipeline.instance")
    def _register_instance_inner(
        self, source, source_features, ref_cloud, ref_features, instance_id,
        t0,
    ) -> Optional[np.ndarray]:
        cfg = self.config
        try:
            ransac_src, ransac_feat = source, source_features
            corr_mode = cfg.registration.corr_mode
            if source_features is None:
                # prepare_mode sparse: descriptors only for the
                # correspondence subset, each equal to the dense one.
                ransac_src, ransac_feat, _ = fused_prepare_sparse(
                    source, self._fpfh_radius())
                corr_mode = "exact"
            if self._mesh is not None:
                refined, coarse = self._register_sharded(
                    source, source_features, ransac_src, ransac_feat,
                    ref_cloud, ref_features, corr_mode, instance_id)
                return self._finish_instance(refined, coarse, instance_id,
                                             t0)
            coarse = self._ransac(ransac_src, ref_cloud, ransac_feat,
                                  ref_features, corr_mode)
            c_fit = host_read("pipeline.fitness", coarse.fitness, float)
            c_rmse = host_read("pipeline.rmse", coarse.rmse, float)
            print(f"RANSAC result: fitness={c_fit:.4f}, RMSE={c_rmse:.6f}")
            icp_threshold = (
                cfg.registration.voxel_size
                * cfg.registration.icp_distance_factor
            )
            try:
                refined = self._icp_accel(
                    source, ref_cloud, coarse.transformation, icp_threshold
                )
                # sync: device faults surface here
                host_read("pipeline.fitness", refined.fitness, float)
            except Exception as icp_err:
                # A failed ICP is retried only where the state already lies
                # on the CPU, the analog of the reference's GPU-ICP
                # try/catch → CPU fallback (pipeline.cpp:114-121). On the
                # card the kernels are never swapped for their plain
                # versions: the instance degrades below.
                if self.device.type != "cpu":
                    raise
                print(
                    f"Accelerator ICP failed ({icp_err}); retrying on the"
                    " host backend"
                )
                self._host_icp_retries += 1
                refined = self._icp(
                    source, ref_cloud, coarse.transformation, icp_threshold
                )
            if source_features is None:
                refined, coarse = self._escalate(
                    source, refined, coarse, ref_cloud, ref_features,
                    instance_id)
            return self._finish_instance(refined, coarse, instance_id, t0)
        except Exception as e:  # degrade like pipeline.cpp:146-149
            print(f"Instance {instance_id} error: {e}")
            self._degraded += 1
            return None

    def _prepare_sharded(self, down):
        """The halo-exchange prepare over the mesh (the lead device's
        fused prepare when its exactness check fails)."""
        return prepare_features_sharded(
            down, self.config.registration, self._mesh,
            halo=self.config.parallel.halo or None)

    def _register_sharded(self, source, source_features, ransac_src,
                          ransac_feat, ref_cloud, ref_features, corr_mode,
                          instance_id):
        """The `parallel:` route: sharded descriptor NN, RANSAC and ICP.
        RANSAC reads the (possibly sparse subset) view, ICP the full
        source; a sparse result below the escalation threshold re-runs
        with the full-prepare descriptors (sharded when the halo check
        allows) and the better fitness wins."""
        cfg = self.config.registration
        refined, coarse = register_prepared_sharded(
            ransac_src, ref_cloud, ransac_feat, ref_features, cfg,
            self._mesh, corr_mode=corr_mode, icp_source=source,
            draws=self._draws)
        self._sharded_registrations += 1
        # sync: faults surface here
        fitness = host_read("pipeline.fitness", refined.fitness, float)
        c_fit = host_read("pipeline.fitness", coarse.fitness, float)
        c_rmse = host_read("pipeline.rmse", coarse.rmse, float)
        print(
            f"RANSAC result: fitness={c_fit:.4f},"
            f" RMSE={c_rmse:.6f} [sharded x"
            f"{self._mesh.devices.size}]"
        )
        if (source_features is None
                and fitness < self._sparse_escalate_threshold()):
            print(
                f"Instance {instance_id}: sparse sharded fitness"
                f" {fitness:.4f} below threshold — escalating through the"
                " full-prepare arm"
            )
            with span("registration.escalate"):
                src_full, src_feat, _ = self._prepare_sharded(source)
                refined2, coarse2 = register_prepared_sharded(
                    src_full, ref_cloud, src_feat, ref_features, cfg,
                    self._mesh, corr_mode=cfg.corr_mode, icp_source=source,
                    draws=self._draws)
                count_event("registration.escalations")
                if host_read("pipeline.fitness", refined2.fitness,
                             float) > fitness:
                    refined, coarse = refined2, coarse2
        return refined, coarse

    def _fpfh_radius(self) -> float:
        return float(np.float32(self.config.registration.voxel_size * 5.0))

    def _ransac(self, source, target, source_features, target_features,
                corr_mode) -> RegistrationResult:
        cfg = self.config.registration
        return ransac_registration(
            source,
            target,
            source_features,
            target_features,
            cfg.voxel_size,
            max_iterations=cfg.ransac_max_iterations,
            confidence=cfg.ransac_confidence,
            seed=cfg.ransac_seed,
            corr_mode=corr_mode,
            two_stage=two_stage_opt(cfg.two_stage),
            draws=self._draws,
        )

    def _escalate(self, source, refined, coarse, ref_cloud, ref_features,
                  instance_id):
        """Sparse-arm escalation: below the threshold, retry the coarse and
        fine stages through the full-prepare arm and keep the better
        result. ``refined``/``coarse`` are the sparse arm's result, from
        the per-instance or the batched path."""
        fitness = host_read("pipeline.fitness", refined.fitness, float)
        if fitness >= self._sparse_escalate_threshold():
            return refined, coarse
        print(
            f"Instance {instance_id}: sparse-arm fitness {fitness:.4f} below"
            " threshold — escalating through the full-prepare arm"
        )
        cfg = self.config.registration
        with span("registration.escalate"):
            src_full, src_feat = prepare_features(source, cfg, "fused")
            coarse2 = self._ransac(src_full, ref_cloud, src_feat,
                                   ref_features, cfg.corr_mode)
            refined2 = self._icp_accel(
                src_full, ref_cloud, coarse2.transformation,
                cfg.voxel_size * cfg.icp_distance_factor,
            )
            count_event("registration.escalations")
            if host_read("pipeline.fitness", refined2.fitness,
                         float) > fitness:
                return refined2, coarse2
        return refined, coarse

    def _finish_instance(
        self, refined, coarse, instance_id, t0
    ) -> np.ndarray:
        """Common result tail: metrics print, min_fitness warn
        (pipeline.cpp:131-134 — warn but still use the pose), camera→world
        pose and the per-instance record."""
        cfg = self.config
        fitness = host_read("pipeline.fitness", refined.fitness, float)
        rmse = host_read("pipeline.rmse", refined.rmse, float)
        print(f"ICP result: fitness={fitness:.4f}, RMSE={rmse:.6f}")
        if fitness < cfg.registration.min_fitness:
            print(f"Instance {instance_id}: low fitness {fitness:.4f}")

        T_camera_object = host_read(
            "pipeline.pose", invert_transform(refined.transformation)).numpy()
        T_world_object = cfg.camera_extrinsics @ T_camera_object
        self.instance_results.append(
            {
                "instance_id": instance_id,
                "fitness": fitness,
                "rmse": host_read("pipeline.rmse", refined.rmse, float),
                "coarse_fitness": host_read("pipeline.fitness",
                                            coarse.fitness, float),
                "T_world_object": T_world_object,
            }
        )

        ms = (time.perf_counter() - t0) * 1000.0
        print(
            f"Instance {instance_id} done in {ms:.1f} ms"
            f" (fitness={fitness:.4f})"
        )
        return T_world_object

    @spanned("pipeline.register")
    def _register_instances(
        self, prepared, ref_cloud, ref_features
    ) -> List[Optional[np.ndarray]]:
        """Register every prepared instance against the reference model.
        Instances whose clouds landed in the same capacity bucket register
        as one batch; singletons take the single-instance path. Returns one
        pose (or None) per input instance, in order."""
        poses: List[Optional[np.ndarray]] = [None] * len(prepared)
        groups: dict = {}
        for i, prep in enumerate(prepared):
            if prep is None:
                continue
            # The sparse gate depends only on capacity and config, so a
            # bucket is uniformly sparse or dense.
            groups.setdefault(prep[0].capacity, []).append(i)

        self._batched_groups = 0  # test/diagnostic hook
        for cap, ids in sorted(groups.items()):
            # With a mesh, each instance already spans every device: no
            # group fan-out, instances run one by one, each distributed.
            if len(ids) >= 2 and self._mesh is None:
                # Every member degrades on its own inside the group, so the
                # group needs no per-instance fallback.
                poses_b = self._register_batch_group(
                    [prepared[i] for i in ids], ids, ref_cloud, ref_features,
                )
                for i, p in zip(ids, poses_b):
                    poses[i] = p
                self._batched_groups += 1
                continue
            for i in ids:
                poses[i] = self._register_instance_inner(
                    prepared[i][0], prepared[i][1], ref_cloud, ref_features,
                    i, time.perf_counter(),
                )
        return poses

    def _register_batch_group(
        self, preps, ids, ref_cloud, ref_features
    ) -> List[Optional[np.ndarray]]:
        """RANSAC+ICP for a same-capacity instance group. The port's RANSAC
        and ICP are host-driven loops, so the members register one by one
        through the single-instance path, each on its own cloud (a sparse
        member escalates from its own result, and the sparse arm runs once
        per member); ``parallel.batched.register_batch`` is the same loop
        over stacked inputs."""
        print(
            f"\n--- Registering {len(ids)} instances batched"
            f" (capacity {preps[0][0].capacity}) ---"
        )
        t0 = time.perf_counter()
        out = [
            self._register_instance_inner(p[0], p[1], ref_cloud, ref_features,
                                          instance_id, time.perf_counter())
            for p, instance_id in zip(preps, ids)
        ]
        ms = (time.perf_counter() - t0) * 1000.0
        print(f"Batch of {len(ids)} registered in {ms:.1f} ms")
        return out

    def _sparse_escalate_threshold(self) -> float:
        """Fitness below which the sparse-prepare arm retries through the
        full-prepare arm ('auto' → min_fitness; 0 disables)."""
        esc = self.config.registration.sparse_escalate_fitness
        if esc == "auto":
            return float(self.config.registration.min_fitness)
        return float(esc)

    def _icp(self, source, target, init_T, threshold):
        cfg = self.config.registration
        return icp_refine(
            source,
            target,
            init_T,
            threshold,
            max_iterations=cfg.icp_max_iterations,
            point_to_plane=cfg.use_point_to_plane,
            src_mode=cfg.src_mode,
        )

    def _icp_accel(self, source, target, init_T, threshold):
        """ICP where the tensors lie (split out so tests can fault it and
        exercise the retry and the degrade branch)."""
        return self._icp(source, target, init_T, threshold)

    # -------------------------------------------------------- reference model
    def _reference_key(self) -> Optional[tuple]:
        """What the downsampled reference model depends on: the model
        file's identity (``os.stat`` of its real path), the registration
        settings and the device. None where no file is read (the
        procedural grid) or it cannot be stat'ed: such a model is never
        kept."""
        cfg = self.config
        if not cfg.reference_model_path:
            return None
        try:
            st = os.stat(os.path.realpath(cfg.reference_model_path))
        except OSError:
            return None
        return ((st.st_dev, st.st_ino, st.st_size, st.st_mtime_ns,
                 st.st_ctime_ns),
                dataclasses.asdict(cfg.registration), self.device)

    def _reference_model(self) -> tuple:
        """(ref_cloud, ref_features). The model is read, uploaded and
        downsampled once while its key holds; a changed key reads it again
        and the new cloud replaces the kept one (the key is taken before
        the file is read, so a file changed meanwhile reloads at the next
        run). Its normals, FPFH and K5's target operand are computed from
        the kept cloud on every run, where the bin cell of ``portbench/``
        judges them. Nothing downstream writes into the kept cloud."""
        cfg = self.config
        key = self._reference_key()
        kept = self._reference
        if key is not None and kept is not None and kept[0] == key:
            ref_down = kept[1]
            print("Reference model unchanged: reusing its downsampled cloud")
            count_event("pipeline.reference.hits")
        else:
            self._reference = None  # the old model's memory goes first
            ref_down = self._load_reference()
            count_event("pipeline.reference.loads")
            if key is not None:
                self._reference = (key, ref_down)
        self._neighbor_mode = resolve_neighbor_mode(ref_down.capacity)
        if self._mesh is not None and self._neighbor_mode == "fused":
            ref_cloud, ref_features, _ = self._prepare_sharded(ref_down)
        else:
            ref_cloud, ref_features = prepare_features(
                ref_down, cfg.registration, self._neighbor_mode
            )
        if self._mesh is None:
            # K5's target operand, once per run.
            ref_features = with_target_operand(ref_features)
        return ref_cloud, ref_features

    def _load_reference(self) -> PointCloud:
        """The model (the procedural grid where no file is named), on the
        device and downsampled."""
        cfg = self.config
        if not cfg.reference_model_path and not cfg.use_camera:
            print("Generating dummy reference model...")
            ref_pts, _ = generate_reference_grid()
            ref_raw = PointCloud.from_numpy(ref_pts, device=self.device)
        else:
            with span("io.load_ply"):
                pts, cols = load_ply(cfg.reference_model_path)
            if len(pts) == 0:
                print("Warning: Empty reference model. Registration may fail.")
            ref_raw = PointCloud.from_numpy(pts, colors=cols,
                                            device=self.device)
        return downsample_bucketed(
            ref_raw,
            cfg.registration,
            capacity=cfg.registration.max_points or None,
        )

    # ------------------------------------------------------------------- run
    @spanned("pipeline.run", root=True)
    def run(self) -> List[np.ndarray]:
        t_start = time.perf_counter()
        print("\n=== Starting Pipeline ===")
        self.instance_results = []  # fresh per run (save_results consistency)
        cfg = self.config

        rgb: Optional[np.ndarray] = None
        depth: Optional[np.ndarray] = None
        K = np.eye(3, dtype=np.float32)

        with span("io.read_frame"):
            if cfg.use_camera:
                print("\n[1/5] Camera capture (RealSense)...")
                from tpu3d_torch.io.camera import RealSenseCamera

                camera = RealSenseCamera(cfg.camera.width,
                                         cfg.camera.height)
                frame = camera.capture() if camera.connect() else None
                if frame is None:
                    print("Camera capture failed.")
                    return []
                rgb, depth = frame
                K = camera.get_intrinsics()
                # The live capture's depth unit wins over the config scale.
                if getattr(camera, "depth_scale", None):
                    cfg.depth.scale_to_meters = 1.0 / camera.depth_scale
                camera.disconnect()
            else:
                print("\n[1/5] Using dummy data...")
                if cfg.dummy_rgb_path and cfg.dummy_depth_path:
                    try:
                        import cv2

                        rgb = cv2.imread(cfg.dummy_rgb_path,
                                         cv2.IMREAD_COLOR)
                        depth = cv2.imread(cfg.dummy_depth_path,
                                           cv2.IMREAD_UNCHANGED)
                        K = np.array(
                            [[900, 0, 640], [0, 900, 360], [0, 0, 1]],
                            np.float32,
                        )
                    except Exception:
                        rgb = depth = None
                if rgb is None or depth is None:
                    print("Generating procedural test scene...")
                    rgb, depth, K = generate_scene(
                        cfg.camera.width, cfg.camera.height,
                        cfg.depth.scale_to_meters
                    )
                if self._forced_K is not None:
                    K = np.asarray(self._forced_K, np.float32)

        print("\n[2/5] Segmentation...")
        if not cfg.use_camera and not cfg.segmentation.masks_input_dir:
            print("Generating dummy mask for box...")
            masks = [generate_box_mask(depth.shape[1], depth.shape[0])]
        else:
            with span("io.get_masks"):
                masks = get_masks(
                    rgb,
                    cfg.segmentation.sam_server_url,
                    cfg.segmentation.sam_query,
                    cfg.segmentation.masks_input_dir,
                )
        if not masks:
            print("No segmentation masks found.")
            return []
        print(f"Found {len(masks)} masks")

        print("\n[3/5] Loading reference model...")
        with span("pipeline.reference"):
            ref_cloud, ref_features = self._reference_model()

        if cfg.visualization != "none":
            self.viewer = SceneViewer()
            self.viewer.start()
            scene = self._scene_cloud(depth, rgb, K)
            if scene is not None:
                self.viewer.set_point_cloud("scene", *scene)

        print(f"\n[4/5] Processing {len(masks)} instances (parallel)...")
        t_proc = time.perf_counter()
        # Phase 1: per-instance prep fans out over the host pool (parity
        # with the reference's ThreadPool, pipeline.cpp:321-339).
        with ThreadPoolExecutor(max_workers=max(cfg.num_threads, 1)) as pool:
            # handoff: the prepares' spans carry this run's request.
            prepare = handoff(self.prepare_instance)
            prep_futures = [
                pool.submit(prepare, masks[i], depth, rgb, K, i)
                for i in range(len(masks))
            ]
            prepared = [f.result() for f in prep_futures]

        # Phase 2: registration; instances sharing a capacity bucket
        # register as one batch, stragglers one by one.
        poses = self._register_instances(prepared, ref_cloud, ref_features)

        raw_waypoints = []
        for i, result in enumerate(poses):
            if result is not None:
                raw_waypoints.append(result)
                if self.viewer is not None and self.viewer.is_running():
                    self.viewer.set_pose(f"pose_{i}", result)
        proc_ms = (time.perf_counter() - t_proc) * 1000.0
        print(f"\nAll instances processed in {proc_ms:.1f} ms")

        with span("pipeline.dedup"):
            final_waypoints = filter_duplicates(raw_waypoints, 0.1)
        self.waypoints = final_waypoints

        if self.viewer is not None and final_waypoints:
            self.viewer.set_path([wp[:3, 3] for wp in final_waypoints])

        if cfg.use_robot:
            print("\n[5/5] Robot execution...")
            robot = Robot(cfg.robot.ip, sleep_fn=self._sleep_fn)
            if robot.connect():
                for i, wp in enumerate(final_waypoints):
                    print(f"\nPicking object {i + 1}/{len(final_waypoints)}")
                    robot.pick(wp, cfg.robot.approach_offset_z)
                robot.disconnect()
        else:
            print("\n[5/5] Robot execution skipped (use_robot=false)")
            print(f"Computed {len(final_waypoints)} pick poses.")

        total_ms = (time.perf_counter() - t_start) * 1000.0
        print(f"\n=== Pipeline complete: {total_ms:.1f} ms ===")

        if self.viewer is not None:
            self.viewer.export_scene_json(self.viewer.json_path)
            self.viewer.export_html(self.viewer.html_path)
            print(f"Viewer scene written to {self.viewer.html_path}")
            print("(open it directly, or call viewer.serve() for the "
                  "live fetch-poll view)")
            self.viewer.stop()
        return final_waypoints

    def save_results(self, path: str):
        """Persist pick poses + per-instance metrics (.npz), so a run's
        outputs can be replayed against the robot without registering."""
        np.savez(
            path,
            waypoints=np.asarray(self.waypoints, np.float32).reshape(-1, 4, 4),
            fitness=np.asarray(
                [r["fitness"] for r in self.instance_results], np.float32
            ),
            rmse=np.asarray(
                [r["rmse"] for r in self.instance_results], np.float32
            ),
            instance_ids=np.asarray(
                [r["instance_id"] for r in self.instance_results], np.int32
            ),
        )

    @staticmethod
    def load_results(path: str) -> dict:
        data = np.load(path)
        return {k: data[k] for k in data.files}

    def _scene_cloud(self, depth, rgb, K):
        """Stride-2 subsampled full-scene cloud for the viewer
        (pipeline.cpp:302-314)."""
        cfg = self.config
        d = depth[::2, ::2].astype(np.float32) / cfg.depth.scale_to_meters
        K2 = np.array(K, np.float32)
        K2[:2] /= 2.0  # stride-2 pixel grid
        cloud = deproject(
            torch.from_numpy(np.ascontiguousarray(d)).to(self.device),
            None if rgb is None else torch.from_numpy(
                np.ascontiguousarray(rgb[::2, ::2])).to(self.device),
            torch.from_numpy(K2),
            cfg.depth.clipping_max,
        )
        m = cloud.mask
        pts = cloud.points[m].cpu().numpy()
        if len(pts) == 0:
            return None
        cols = None if cloud.colors is None else cloud.colors[m].cpu().numpy()
        return pts, cols
