"""Procedural demo scene — the hermetic integration fixture.

Byte-level parity with the reference's dummy-data branch
(src/pipeline.cpp:212-241, :251-257, :275-282):
  - RGB-D frame: dark-grey background (BGR 50,50,50), checkerboard floor at
    z = 1.0 m with 50-px cells (BGR 200,200,200 where ((u/50)+(v/50)) even),
    a red box (BGR 0,0,255) at z = 0.8 m where |u−cx| < 100 and |v−cy| < 100,
    fx = fy = 900, cx = w/2, cy = h/2, u16 depth = z · scale_to_meters;
  - dummy mask: filled 201×201 rectangle (cv::rectangle corners inclusive)
    centered at (cols/2, rows/2) — deliberately one ring of floor pixels
    wider than the 199-px-wide box;
  - dummy reference model: planar grid x,y ∈ [−0.1, 0.1] at 5 mm pitch with
    the reference's float32 accumulation loop (it determines whether the
    last row lands exactly on 0.1), normals +z.
"""

from __future__ import annotations

import numpy as np


def generate_scene(width: int, height: int, scale_to_meters: float = 1000.0):
    """Returns (rgb_bgr u8[H,W,3], depth u16[H,W], K f32[3,3])."""
    w, h = width, height
    fx = fy = 900.0
    cx, cy = w / 2.0, h / 2.0

    u = np.arange(w)[None, :].astype(np.float32)
    v = np.arange(h)[:, None].astype(np.float32)
    in_box = (np.abs(u - cx) < 100) & (np.abs(v - cy) < 100)

    z = np.where(in_box, np.float32(0.8), np.float32(1.0))
    depth = (z * np.float32(scale_to_meters)).astype(np.uint16)

    rgb = np.full((h, w, 3), 50, np.uint8)
    checker = ((np.arange(w)[None, :] // 50) + (np.arange(h)[:, None] // 50)) % 2 == 0
    rgb[checker & ~in_box] = (200, 200, 200)
    rgb[in_box] = (0, 0, 255)  # red in BGR

    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    return rgb, depth, K


def generate_box_mask(width: int, height: int) -> np.ndarray:
    """u8[H,W] — filled rectangle, corners (c−100, c−100)..(c+100, c+100)
    inclusive (cv::rectangle thickness −1 fills both corners)."""
    mask = np.zeros((height, width), np.uint8)
    cx, cy = width // 2, height // 2
    mask[max(cy - 100, 0) : cy + 101, max(cx - 100, 0) : cx + 101] = 255
    return mask


def generate_reference_grid():
    """(points f32[N,3], normals f32[N,3]) — the planar dummy reference.

    Reproduces the reference's float32 accumulation loop
    (``for (float x = -0.1f; x <= 0.1f; x += 0.005f)``, pipeline.cpp:277) so
    the grid has the exact same node positions and count.
    """
    axis = []
    x = np.float32(-0.1)
    limit = np.float32(0.1)
    step = np.float32(0.005)
    while x <= limit:
        axis.append(x)
        x = np.float32(x + step)
    axis = np.asarray(axis, np.float32)
    xs, ys = np.meshgrid(axis, axis, indexing="ij")
    pts = np.stack([xs.ravel(), ys.ravel(), np.zeros_like(xs).ravel()], axis=1)
    normals = np.zeros_like(pts)
    normals[:, 2] = 1.0
    return pts.astype(np.float32), normals.astype(np.float32)
