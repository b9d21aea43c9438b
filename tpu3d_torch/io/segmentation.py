"""Instance-segmentation client: SAM-server dispatch + directory fallback.

A copy of ``tpu3d/io/segmentation.py``, but the mask resize takes cv2's
nearest resize where cv2 is installed, else the port's host runtime
(``tpu3d_torch.native``) when it is built, else numpy's: the order of the
three resizes' measured times (``chip_smoke.py`` phase 5d).

Mirrors the reference ``Segmentation`` (src/segmentation.cpp):
  - ``get_masks`` tries the SAM server, then falls back to a mask directory
    (segmentation.cpp:54-66);
  - ``get_masks_from_sam`` posts the frame to an HTTP SAM2 endpoint. The
    reference stubs this entirely (prints "not yet implemented",
    segmentation.cpp:44-52); here the HTTP call is implemented but degrades
    to [] on any failure (incl. zero-egress environments), preserving the
    dispatcher's fallback behavior;
  - ``load_masks_from_dir``: sorted png/jpg/jpeg scan, grayscale load,
    binary threshold at 10 (segmentation.cpp:12-42).
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import List

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except Exception:
    cv2 = None
    _HAS_CV2 = False


def load_masks_from_dir(masks_dir: str) -> List[np.ndarray]:
    if not os.path.isdir(masks_dir):
        print(f"Mask directory not found: {masks_dir}")
        return []
    files = sorted(
        os.path.join(masks_dir, f)
        for f in os.listdir(masks_dir)
        if os.path.splitext(f)[1].lower() in (".png", ".jpg", ".jpeg")
    )
    masks = []
    for path in files:
        m = _imread_gray(path)
        if m is not None:
            masks.append(np.where(m > 10, 255, 0).astype(np.uint8))
    print(f"Loaded {len(masks)} masks from {masks_dir}")
    return masks


def _imread_gray(path: str):
    if _HAS_CV2:
        return cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    try:
        from PIL import Image

        return np.asarray(Image.open(path).convert("L"))
    except Exception:
        return None


def get_masks_from_sam(
    rgb_bgr: np.ndarray, server_url: str, query: str, timeout: float = 10.0
) -> List[np.ndarray]:
    """POST the frame to a SAM2 server; [] on any failure.

    Protocol: JSON {"query": str, "image": base64 PNG} → {"masks": [base64
    PNG, ...]} (the reference never implemented its client; this defines a
    concrete contract for the same config keys).
    """
    if not server_url:
        return []
    try:
        import base64
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(rgb_bgr[..., ::-1]).save(buf, format="PNG")
        payload = json.dumps(
            {
                "query": query,
                "image": base64.b64encode(buf.getvalue()).decode("ascii"),
            }
        ).encode("utf-8")
        req = urllib.request.Request(
            server_url, data=payload, headers={"Content-Type": "application/json"}
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            out = json.loads(resp.read())
        masks = []
        for b64 in out.get("masks", []):
            img = Image.open(io.BytesIO(base64.b64decode(b64))).convert("L")
            m = np.asarray(img)
            masks.append(np.where(m > 10, 255, 0).astype(np.uint8))
        return masks
    except Exception as e:
        print(f"SAM segmentation unavailable ({e}); falling back")
        return []


def get_masks(
    rgb_bgr: np.ndarray, sam_server_url: str, sam_query: str, masks_dir: str
) -> List[np.ndarray]:
    """Dispatcher matching segmentation.cpp:54-66: SAM first, dir fallback."""
    if sam_server_url:
        masks = get_masks_from_sam(rgb_bgr, sam_server_url, sam_query)
        if masks:
            return masks
    if masks_dir:
        return load_masks_from_dir(masks_dir)
    return []


def resize_mask_nearest(mask: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv::resize INTER_NEAREST equivalent (pipeline.cpp:39-41): cv2's
    where it is installed, else the native pooled implementation when
    built (it also binarizes at 10, which depth_preprocess's > 10 test
    then passes through unchanged), else numpy's. cv2 comes first because
    it was the fastest of the three on the host of an H100 machine
    (``chip_smoke.py`` phase 5d, a half-frame mask brought up to 1280 x
    720: cv2 ~0.12 ms, native ~0.9, numpy ~3.5)."""
    if mask.shape == (height, width):
        return mask
    if _HAS_CV2:
        return cv2.resize(mask, (width, height), interpolation=cv2.INTER_NEAREST)
    from tpu3d_torch import native

    if native.available():
        out = native.resize_mask_nearest_threshold(mask, height, width)
        if out is not None:
            return out
    ys = (np.arange(height) * mask.shape[0] / height).astype(np.int64)
    xs = (np.arange(width) * mask.shape[1] / width).astype(np.int64)
    return mask[ys[:, None], xs[None, :]]
