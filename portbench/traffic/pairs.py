"""Generator of scan pairs: a pool of seeded (source, target, pose) triples.

A frozen copy of the port's ``models/fixtures.make_pair`` surface (a
bumpy height field whose curvature sits at the FPFH radius), widened by
the parameters a traffic mix needs: the patch's extent, seeded Gaussian
bumps that break the sinusoids' near-symmetry on small patches, and a
seeded rigid pose per pair. The source is the target's points moved by
the inverse pose, so registering source onto target recovers the pose.

Parameters (the mix's JSON): ``points``, ``extent`` (m, the side of the
square patch), ``surface_voxel`` (m, sets the sinusoids' scale as the
fixture's ``voxel`` does), ``bumps``, ``bump_sigma`` ([lo, hi] m),
``bump_height`` (m, ± amplitude), ``rotation_sigma`` (rad, per
angle-axis component), ``translation_sigma`` (m), ``pool``.
"""

from __future__ import annotations

import numpy as np


def _rotation(aa: np.ndarray) -> np.ndarray:
    th = float(np.linalg.norm(aa))
    if th == 0.0:
        return np.eye(3)
    k = aa / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def surface(rng, params) -> np.ndarray:
    n, ext = int(params["points"]), float(params["extent"])
    xy = rng.uniform(-ext / 2, ext / 2, size=(n, 2)).astype(np.float32)
    voxel = float(params["surface_voxel"])
    r = 5.0 * voxel
    w1, w2, w3 = 1.2 / r, 0.9 / r, 0.35 / r
    x, y = xy[:, 0].astype(np.float64), xy[:, 1].astype(np.float64)
    z = (0.7
         + 2.5 * voxel * np.sin(w1 * x) * np.cos(w1 * 0.8 * y)
         + 4.0 * voxel * np.sin(w2 * x + 1.3) * np.sin(w2 * 0.7 * y)
         + 8.0 * voxel * np.cos(w3 * x - 0.4) * np.cos(w3 * 1.1 * y))
    nb = int(params.get("bumps", 0))
    if nb:
        lo, hi = params["bump_sigma"]
        amp = float(params["bump_height"])
        cx = rng.uniform(-ext / 2, ext / 2, nb)
        cy = rng.uniform(-ext / 2, ext / 2, nb)
        sig = rng.uniform(lo, hi, nb)
        a = rng.uniform(-amp, amp, nb)
        for i in range(nb):
            z = z + a[i] * np.exp(-((x - cx[i]) ** 2 + (y - cy[i]) ** 2)
                                  / (2.0 * sig[i] ** 2))
    return np.column_stack([xy, z]).astype(np.float32)


def generate(params: dict, config: dict, seed: int) -> list[dict]:
    """``pool`` pairs, each {'source', 'target' (f32[n, 3]), 'pose'
    (f64[4, 4], source → target)}: the same for the same seed."""
    rng = np.random.default_rng([seed, 0x5ca9])
    out = []
    for _ in range(int(params["pool"])):
        tgt = surface(rng, params)
        R = _rotation(rng.normal(0.0, float(params["rotation_sigma"]), 3))
        t = rng.normal(0.0, float(params["translation_sigma"]), 3)
        src = ((tgt.astype(np.float64) - t) @ R).astype(np.float32)
        pose = np.eye(4)
        pose[:3, :3], pose[:3, 3] = R, t
        out.append({"source": src, "target": tgt, "pose": pose})
    return out
