"""Entry driver of the scan-registration service: one request is
``tpu3d_torch.registration.register_pair(source, target, config)`` on
clouds already on the device, from the clouds to the refined pose, ended
by reading the pose back."""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness.capture import PatchPoint
from portbench.reference.geometry import pose_gap


def stage_points(reg, pipeline=None) -> list:
    """The registration core's stage functions, in the namespaces their
    callers look them up in, with the layer each span belongs to."""
    from tpu3d_torch.ops import ransac

    out = []
    for mod in (reg, pipeline):
        if mod is None:
            continue
        out += [
            PatchPoint(mod, "downsample_bucketed", "prepare.downsample"),
            PatchPoint(mod, "prepare_features", "prepare.features"),
            PatchPoint(mod, "fused_prepare_sparse", "prepare.sparse"),
            PatchPoint(mod, "ransac_registration", "ransac"),
            PatchPoint(mod, "icp_refine", "icp"),
        ]
    out.append(PatchPoint(ransac, "feature_correspondences"))
    return out


class Driver:
    def __init__(self, config: dict, items: list, device: str):
        from tpu3d_torch import registration
        from tpu3d_torch.config import RegistrationConfig
        from tpu3d_torch.types import PointCloud

        self.reg = registration
        self.cfg = RegistrationConfig(voxel_size=config["voxel_size"],
                                      **config["registration"])
        self.gate = config["gate"]
        self.pairs = [
            (PointCloud.from_numpy(it["source"], device=device),
             PointCloud.from_numpy(it["target"], device=device), it["pose"])
            for it in items]
        self.pool = len(self.pairs)

    def patch_points(self) -> list:
        return stage_points(self.reg)

    def request(self, i: int) -> dict:
        src, tgt, pose = self.pairs[i]
        refined, _ = self.reg.register_pair(src, tgt, self.cfg)
        T = refined.transformation.cpu().double()  # waits for the device
        ok = bool(np.isfinite(T.numpy()).all())
        rad, m = pose_gap(T, torch.from_numpy(pose))
        miss = not (rad < self.gate["rotation_rad"]
                    and m < self.gate["translation_m"])
        return {"ok": ok, "gate_miss": miss, "gate": [rad, m]}

    def frame_inputs(self, i: int):
        return None

    def close(self):
        self.pairs = []
