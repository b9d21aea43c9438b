"""Entry driver of the bin-picking cell: one request is one
``tpu3d_torch.pipeline.pipeline.Pipeline.run()``, file-fed as the CLI
runs it: the depth PNG, a gray RGB PNG, the request's mask directory and
the reference model's PLY, all written once at set-up into a directory
under ``TMPDIR``. The reference model is the frame itself, unfiltered, so
every instance's true pose is the identity."""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

from portbench.drivers.register_pair import stage_points
from portbench.harness.capture import PatchPoint
from portbench.reference.geometry import pose_gap

# Pipeline.run() reads dummy data with these intrinsics.
RUN_K = np.array([[900, 0, 640], [0, 900, 360], [0, 0, 1]], np.float32)


def write_ply(path: str, pts: np.ndarray):
    """ASCII PLY, each coordinate written so that it reads back exactly."""
    pts = np.asarray(pts, np.float32).reshape(-1, 3)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(pts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "end_header\n")
        f.write(("%.9g %.9g %.9g\n" * len(pts))
                % tuple(pts.astype(np.float64).ravel().tolist()))


def deproject_all(depth: np.ndarray, K: np.ndarray, scale: float,
                  clip: float) -> np.ndarray:
    """Every valid pixel of the unfiltered frame as a point (float32)."""
    h, w = depth.shape
    z = depth.astype(np.float32) / np.float32(scale)
    u = np.arange(w, dtype=np.float32)[None, :]
    v = np.arange(h, dtype=np.float32)[:, None]
    x = (u - K[0, 2]) * z / K[0, 0]
    y = (v - K[1, 2]) * z / K[1, 1]
    pts = np.stack([x, y, z], -1).reshape(-1, 3)
    keep = ((z > 0) & (z <= clip)).reshape(-1)
    return pts[keep]


class Driver:
    def __init__(self, config: dict, items: dict, device: str):
        import cv2  # the pipeline reads the frame with it

        from tpu3d_torch import registration
        from tpu3d_torch.config import PipelineConfig, RegistrationConfig
        from tpu3d_torch.pipeline import pipeline

        self.pl = pipeline
        self.device = device
        self.items = items
        if not np.array_equal(items["K"], RUN_K):
            raise ValueError("the frame's intrinsics differ from run()'s")
        d = config["depth"]
        if d["bilateral_filter"]:
            raise NotImplementedError("the reference has no bilateral filter")
        self.depth_cfg = d
        self.gate = config["gate"]
        self.dir = tempfile.mkdtemp(prefix="portbench-frames-")
        depth = items["depth"]
        h, w = depth.shape
        cfg = PipelineConfig()
        cfg.use_camera = cfg.use_robot = False
        cfg.use_gpu = device == "cuda"
        cfg.visualization = "none"
        cfg.camera.width, cfg.camera.height = w, h
        cfg.depth.scale_to_meters = d["scale_to_meters"]
        cfg.depth.clipping_max = d["clipping_max"]
        cfg.depth.bilateral_filter = d["bilateral_filter"]
        cfg.registration = RegistrationConfig(
            voxel_size=config["voxel_size"], **config["registration"])
        cfg.num_threads = config["num_threads"]
        cfg.segmentation.sam_server_url = ""
        cfg.camera_extrinsics = np.eye(4, dtype=np.float32)
        cfg.dummy_depth_path = os.path.join(self.dir, "depth.png")
        cfg.dummy_rgb_path = os.path.join(self.dir, "rgb.png")
        cfg.reference_model_path = os.path.join(self.dir, "reference.ply")
        ok = cv2.imwrite(cfg.dummy_depth_path, depth) and cv2.imwrite(
            cfg.dummy_rgb_path, np.full((h, w, 3), 90, np.uint8))
        self.mask_dirs = []
        for s, masks in enumerate(items["mask_sets"]):
            md = os.path.join(self.dir, f"masks_{s}")
            os.makedirs(md)
            for i, m in enumerate(masks):
                ok = ok and cv2.imwrite(os.path.join(md, f"mask_{i:03d}.png"),
                                        m)
            self.mask_dirs.append(md)
        if not ok:
            raise OSError("could not write the frame's images")
        write_ply(cfg.reference_model_path,
                  deproject_all(depth, items["K"], d["scale_to_meters"],
                                d["clipping_max"]))
        self.cfg = cfg
        self.pipe = pipeline.Pipeline(cfg, sleep_fn=lambda s: None)
        self.reg = registration
        self.pool = len(self.mask_dirs)

    def patch_points(self) -> list:
        pl, pipe = self.pl, self.pipe
        return [
            PatchPoint(pl, "get_masks", "io.get_masks"),
            PatchPoint(pl, "load_ply", "io.load_ply"),
            PatchPoint(pipe, "prepare_instance", "pipeline.prepare_instance"),
            PatchPoint(pipe, "_prepare_instance_inner"),
            PatchPoint(pl, "deproject"),
            PatchPoint(pipe, "_register_instances", "pipeline.register"),
        ] + stage_points(self.reg, pl)

    def request(self, i: int) -> dict:
        pipe = self.pipe
        self.cfg.segmentation.masks_input_dir = self.mask_dirs[i]
        degraded, retries = pipe._degraded, pipe._host_icp_retries
        pipe.run()  # the poses are read back to the host inside
        n = len(self.items["mask_sets"][i])
        results = pipe.instance_results
        ok = (len(results) == n and pipe._degraded == degraded
              and pipe._host_icp_retries == retries)
        eye = torch.eye(4, dtype=torch.float64)
        gaps = [pose_gap(torch.from_numpy(np.asarray(r["T_world_object"],
                                                     np.float64)), eye)
                for r in results]
        miss = len(gaps) < n or any(
            not (rad < self.gate["rotation_rad"]
                 and m < self.gate["translation_m"]) for rad, m in gaps)
        worst = [max((g[0] for g in gaps), default=float("inf")),
                 max((g[1] for g in gaps), default=float("inf"))]
        return {"ok": ok, "gate_miss": miss, "gate": worst}

    def frame_inputs(self, i: int) -> dict:
        d = self.depth_cfg
        return {"depth": self.items["depth"],
                "masks": self.items["mask_sets"][i], "K": self.items["K"],
                "scale": d["scale_to_meters"], "clip": d["clipping_max"],
                "bilateral": d["bilateral_filter"],
                "device": self.device}

    def close(self):
        shutil.rmtree(self.dir, ignore_errors=True)

