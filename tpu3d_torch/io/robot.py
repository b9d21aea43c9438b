"""xArm robot client (simulation-mode parity with the reference).

Mirrors src/robot.cpp exactly: connect always succeeds in simulation mode
(:17-23), ``move`` converts a 4x4 pose to mm + ZYX RPY degrees with the
gimbal-lock branch (:38-56), logs and dwells 1 s when waiting (:58-66);
``pick`` = approach (pose·Trans(0,0,offset_z)) → slow descend (speed 10,
−1 mm) → close gripper → 1 s dwell → retract (:81-106). ``get_pose``
returns identity (:69-71). A real xArm SDK can be plugged in via the
``sdk`` hook without touching the pipeline. A copy of
``tpu3d/io/robot.py``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpu3d_torch.ops.transforms import matrix_to_rpy_zyx


class Robot:
    def __init__(self, ip: str, sdk=None, sleep_fn=time.sleep):
        self.ip = ip
        self.connected = False
        self._sdk = sdk  # placeholder for the real xArm SDK (robot.hpp:28)
        self._sleep = sleep_fn
        self.move_log: list[tuple] = []  # (x_mm, y_mm, z_mm, rpy_deg, speed)
        print(f"Robot created for IP: {ip}")

    def connect(self) -> bool:
        print(f"Connecting to xArm at {self.ip}...")
        self.connected = True
        print("xArm connected (simulation mode).")
        return True

    def disconnect(self):
        if self.connected:
            self.connected = False
            print("xArm disconnected.")

    def move(self, pose: np.ndarray, speed: int = 80, wait: bool = True) -> bool:
        if not self.connected:
            print("Robot not connected.")
            return False
        pose = np.asarray(pose, np.float32)
        xyz_mm = pose[:3, 3] * 1000.0
        rpy_deg = np.degrees(
            matrix_to_rpy_zyx(torch.from_numpy(pose[:3, :3])).numpy())
        self.move_log.append((*xyz_mm.tolist(), rpy_deg.tolist(), speed))
        print(
            f"Moving to: [{xyz_mm[0]:.6g}, {xyz_mm[1]:.6g}, {xyz_mm[2]:.6g}] mm,"
            f" RPY=[{rpy_deg[0]:.6g}, {rpy_deg[1]:.6g}, {rpy_deg[2]:.6g}] deg"
            f" speed={speed}"
        )
        if wait:
            self._sleep(1.0)
        return True

    def get_pose(self) -> np.ndarray:
        return np.eye(4, dtype=np.float32)

    def open_gripper(self):
        print("Opening gripper.")

    def close_gripper(self):
        print("Closing gripper.")

    def pick(self, pose: np.ndarray, approach_offset_z: float) -> bool:
        if not self.connected:
            return False
        pose = np.asarray(pose, np.float32)
        offset = np.eye(4, dtype=np.float32)
        offset[2, 3] = approach_offset_z
        approach = pose @ offset

        print("Moving to approach position...")
        self.move(approach)

        pick_offset = np.eye(4, dtype=np.float32)
        pick_offset[2, 3] = -0.001
        print("Descending to pick position...")
        self.move(pose @ pick_offset, 10)  # slow approach

        self.close_gripper()
        self._sleep(1.0)

        print("Retracting...")
        self.move(approach)
        print("Pick completed.")
        return True
