"""Model/asset handling: PLY I/O, procedural demo assets, test fixtures."""

from tpu3d_torch.models.fixtures import make_pair
from tpu3d_torch.models.ply import load_ply, save_ply
from tpu3d_torch.models.procedural import (
    generate_box_mask,
    generate_reference_grid,
    generate_scene,
)

__all__ = [
    "generate_box_mask",
    "generate_reference_grid",
    "generate_scene",
    "load_ply",
    "make_pair",
    "save_ply",
]
