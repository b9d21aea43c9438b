"""Plain reference of the depth front end: scale, instance mask, pinhole
back-projection (no import of the program).

``frame`` is the request's raw input as the harness made it: ``depth``
(u16[H, W] numpy), ``masks`` (u8[H, W] each, instance i the i-th),
``K`` (3 × 3), ``scale`` (depth units per metre), ``clip`` (m),
``bilateral`` (bool; the reference has no filter, as the deployment runs
none) and ``device``. A point is valid where 0 < z ≤ clip. The
arithmetic is element by element, so the control computes it in
bfloat16 (:meth:`Precision.elementwise`).
"""

from __future__ import annotations

import torch

from portbench.reference.geometry import Precision


def deproject_instance(frame: dict, instance: int, prec: Precision):
    """(points (H·W, 3), valid (H·W,)) of one instance, row-major pixels."""
    dev = frame["device"]
    dt = prec.dtype
    depth = torch.from_numpy(frame["depth"].astype("float64")).to(dev)
    mask = torch.from_numpy(frame["masks"][instance]).to(dev)
    if frame["bilateral"]:
        raise NotImplementedError("the reference has no bilateral filter")
    r = prec.elementwise
    z = r(torch.where(mask > 10, depth / frame["scale"], 0.0).to(dt))
    h, w = z.shape
    K = frame["K"]
    fx, fy, cx, cy = (float(K[0][0]), float(K[1][1]), float(K[0][2]),
                      float(K[1][2]))
    u = torch.arange(w, dtype=dt, device=dev)[None, :].expand(h, w)
    v = torch.arange(h, dtype=dt, device=dev)[:, None].expand(h, w)
    pts = torch.stack([r(r(r(u - cx) * z) / fx), r(r(r(v - cy) * z) / fy),
                       z], -1)
    valid = (z > 0.0) & (z <= frame["clip"])
    return pts.reshape(-1, 3), valid.reshape(-1)
