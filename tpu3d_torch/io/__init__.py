"""Host-side I/O edges: camera, segmentation client, robot client."""

from tpu3d_torch.io.camera import RealSenseCamera
from tpu3d_torch.io.robot import Robot
from tpu3d_torch.io.segmentation import (
    get_masks,
    get_masks_from_sam,
    load_masks_from_dir,
    resize_mask_nearest,
)

__all__ = [
    "RealSenseCamera",
    "Robot",
    "get_masks",
    "get_masks_from_sam",
    "load_masks_from_dir",
    "resize_mask_nearest",
]
