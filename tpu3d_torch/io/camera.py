"""RealSense camera shim (host-side I/O edge).

Mirrors the reference's ``RealSenseCamera`` (src/camera.cpp:15-93): BGR8
color + Z16 depth at the requested size @30fps, device depth scale, a
30-frame auto-exposure settle, depth aligned to color, and intrinsics
served from the color stream profile RIGHT AFTER connect (camera.cpp:84-93
— they do not wait for a capture). The SDK is resolved lazily at
``connect()`` — on machines without pyrealsense2 connect() fails cleanly
just like the reference's pipeline.start, and the pipeline degrades per
config (use_camera=false); tests inject a fake ``pyrealsense2`` module.
"""

from __future__ import annotations

import numpy as np


def _load_sdk():
    """Resolve pyrealsense2 at call time (injectable for tests)."""
    try:
        import pyrealsense2 as rs  # type: ignore

        return rs
    except Exception:
        return None


class RealSenseCamera:
    def __init__(self, width: int = 1280, height: int = 720):
        self.width = width
        self.height = height
        self.depth_scale = 0.001
        self._pipeline = None
        self._align = None
        self._intrinsics = None

    def connect(self) -> bool:
        rs = _load_sdk()
        if rs is None:
            print("RealSense SDK unavailable — cannot connect camera")
            return False
        try:
            self._pipeline = rs.pipeline()
            cfg = rs.config()
            cfg.enable_stream(
                rs.stream.color, self.width, self.height, rs.format.bgr8, 30
            )
            cfg.enable_stream(
                rs.stream.depth, self.width, self.height, rs.format.z16, 30
            )
            profile = self._pipeline.start(cfg)
            sensor = profile.get_device().first_depth_sensor()
            self.depth_scale = float(sensor.get_depth_scale())
            # Intrinsics from the color stream profile, available as soon
            # as the pipeline starts (camera.cpp:84-93) — get_intrinsics()
            # must be valid BEFORE any capture.
            try:
                stream = profile.get_stream(rs.stream.color)
                self._intrinsics = (
                    stream.as_video_stream_profile().get_intrinsics()
                )
            except Exception as e:
                print(f"Could not read color intrinsics at connect: {e}")
            self._align = rs.align(rs.stream.color)
            for _ in range(30):  # AE settle, camera.cpp:30
                self._pipeline.wait_for_frames()
            return True
        except Exception as e:
            print(f"Camera connect failed: {e}")
            return False

    def capture(self):
        """Returns (rgb_bgr u8[H,W,3], depth u16[H,W]) or None on failure."""
        if self._pipeline is None:
            return None
        try:
            frames = self._align.process(self._pipeline.wait_for_frames())
            color = frames.get_color_frame()
            depth = frames.get_depth_frame()
            if not color or not depth:
                return None
            rgb = np.asanyarray(color.get_data()).copy()
            d = np.asanyarray(depth.get_data()).copy()
            # Refresh from the live frame (tracks any profile change).
            self._intrinsics = (
                color.profile.as_video_stream_profile().intrinsics
            )
            return rgb, d
        except Exception as e:
            print(f"Capture failed: {e}")
            return None

    def get_intrinsics(self) -> np.ndarray:
        i = self._intrinsics
        K = np.eye(3, dtype=np.float32)
        if i is not None:
            K[0, 0], K[1, 1] = i.fx, i.fy
            K[0, 2], K[1, 2] = i.ppx, i.ppy
        return K

    def disconnect(self):
        if self._pipeline is not None:
            try:
                self._pipeline.stop()
            finally:
                self._pipeline = None
