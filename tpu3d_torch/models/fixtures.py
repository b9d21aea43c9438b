"""Synthetic registration fixtures.

``make_pair`` is a copy of ``bench.py``'s fixture, kept here so the port's
own scripts do not depend on the benchmark file. ``bin_frame`` is a depth
frame for driving the pipeline.
"""

from __future__ import annotations

import numpy as np


def make_pair(n: int, seed: int = 0, voxel: float = 0.005):
    """Bumpy-surface pair with curvature at the FPFH-radius (5×voxel) scale
    so descriptors are discriminative — a flat/slowly-varying surface makes
    FPFH degenerate regardless of implementation (same failure as the
    reference's planar demo scene)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.5, 0.5, size=(n, 2)).astype(np.float32)
    r = 5.0 * voxel
    w1, w2, w3 = 1.2 / r, 0.9 / r, 0.35 / r
    z = (
        0.7
        + 2.5 * voxel * np.sin(w1 * xy[:, 0]) * np.cos(w1 * 0.8 * xy[:, 1])
        + 4.0 * voxel * np.sin(w2 * xy[:, 0] + 1.3) * np.sin(w2 * 0.7 * xy[:, 1])
        + 8.0 * voxel * np.cos(w3 * xy[:, 0] - 0.4) * np.cos(w3 * 1.1 * xy[:, 1])
    )
    tgt = np.column_stack([xy, z]).astype(np.float32)
    aa = np.array([0.08, -0.06, 0.1])
    th = np.linalg.norm(aa)
    k = aa / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(np.float32)
    t = np.array([0.02, -0.015, 0.01], np.float32)
    src = ((tgt - t) @ R).astype(np.float32)
    return src, tgt, R, t


def bin_frame(width: int = 1280, height: int = 720, seed: int = 0,
              bumps: int = 60, focal: float = 900.0,
              scale: float = 10000.0):
    """(u16[H, W] depth in units of 1/``scale`` m, f32[3, 3] pinhole K) of
    a bumpy surface 0.6 m away. The sinusoids of the pipeline tests'
    bumpy frame, at that frame's 300-px focal length (so pixel
    coordinates are divided by ``focal``/300) and amplitudes of 6 and
    3 mm, plus ``bumps`` seeded Gaussian bumps (σ 12-40 px, ±12 mm) that
    break the sinusoids' translational near-symmetry, so that a crop of
    the frame registers against the whole frame at one place only. At
    1280 × 720 and voxel 0.002 the frame has ~125k voxels, a 320-px
    square crop ~14k and a 74-px one ~800."""
    rng = np.random.default_rng(seed)
    u = np.arange(width)[None, :]
    v = np.arange(height)[:, None]
    us, vs = u * (300.0 / focal), v * (300.0 / focal)
    z = 0.6 + 0.006 * np.sin(us * 0.11) * np.cos(vs * 0.13) + 0.003 * np.sin(
        us * 0.031 + vs * 0.027)
    for cu, cv, s, a in zip(rng.uniform(0, width, bumps),
                            rng.uniform(0, height, bumps),
                            rng.uniform(12.0, 40.0, bumps),
                            rng.uniform(-0.012, 0.012, bumps)):
        z = z + a * np.exp(-((u - cu) ** 2 + (v - cv) ** 2) / (2.0 * s * s))
    K = np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]],
                 np.float32)
    return (z * scale).astype(np.uint16), K
