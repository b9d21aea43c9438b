"""Generator of bin-picking frames: one seeded depth frame and a pool of
instance mask sets.

The frame is a frozen copy of the port's ``models/fixtures.bin_frame``: a
bumpy surface 0.6 m from a pinhole camera (sinusoids plus seeded Gaussian
bumps that break their near-symmetry, so a crop registers against the
whole frame at one place only), in depth units of 1/``scale`` m. Each
mask set places square instances of the listed sizes without overlap.

Parameters (the mix's JSON): ``bumps``, ``pool``, and ``instances``: a
list of {``count``, ``side`` ([lo, hi] px)}: each group's sides are
evenly spaced over its range, the same for every seed, and drawn in a
seeded order. The frame's size and focal length come from the
configuration's ``camera``, its depth unit from ``depth.scale_to_meters``.
"""

from __future__ import annotations

import numpy as np


def surface(rng, width: int, height: int, focal: float, bumps: int):
    """(f64[H, W] depth in m, f32[3, 3] K)."""
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
    return z, K


def grid(width: int, height: int, instances: list):
    """(cols, rows, cell width, cell height) of a grid of cells as large as
    the largest square."""
    side_max = max(int(g["side"][1]) for g in instances)
    cols, rows = width // side_max, height // side_max
    if sum(int(g["count"]) for g in instances) > cols * rows:
        raise ValueError("the instances do not fit the frame")
    return cols, rows, width // cols, height // rows


def place(rng, cells, groups: list, sides: list, shape) -> list:
    """[(x0, y0, side)]: each group's squares, each in its own cell (drawn
    from ``cells``) at a seeded offset inside it, so that none overlap.
    ``sides``: an iterator of each group's square sides."""
    cols, _, cw, ch = shape
    squares = []
    for g, group_sides in zip(groups, sides):
        for _ in range(int(g["count"])):
            side, cell = next(group_sides), next(cells)
            x0 = (cell % cols) * cw + int(rng.integers(0, cw - side + 1))
            y0 = (cell // cols) * ch + int(rng.integers(0, ch - side + 1))
            squares.append((x0, y0, side))
    return squares


def generate(params: dict, config: dict, seed: int) -> dict:
    """{'depth', 'K', 'mask_sets'}: the same for the same seed."""
    rng = np.random.default_rng([seed, 0xb1f])
    cam = config["camera"]
    w, h = int(cam["width"]), int(cam["height"])
    z, K = surface(rng, w, h, float(cam["focal"]), int(params["bumps"]))
    # Every seed gets the same sides (evenly spaced over each group's
    # range), in its own order: the seed moves the squares, not the work.
    groups = params["instances"]
    pool = int(params["pool"])
    sides = [iter(rng.permutation(np.linspace(
        g["side"][0], g["side"][1], int(g["count"]) * pool).round()
        .astype(int)).tolist()) for g in groups]
    shape = grid(w, h, groups)
    n = sum(int(g["count"]) for g in groups)
    sets = [place(rng, iter(rng.permutation(shape[0] * shape[1])[:n]),
                  groups, sides, shape) for _ in range(pool)]
    masks = []
    for squares in sets:
        ms = []
        for x0, y0, side in squares:
            m = np.zeros((h, w), np.uint8)
            m[y0:y0 + side, x0:x0 + side] = 255
            ms.append(m)
        masks.append(ms)
    scale = float(config["depth"]["scale_to_meters"])
    return {"depth": (z * scale).astype(np.uint16), "K": K,
            "mask_sets": masks}
