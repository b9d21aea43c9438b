"""Registration operators: plain PyTorch around hand-written CUDA kernels
(``features`` K2-K4, ``nn`` K5, ``ransac_score`` K6, ``icp_stats`` K7,
``nn_walk`` K8, ``depth`` K9). The exports mirror ``tpu3d.ops`` where the
port has the function, except ``deproject``, whose name would hide its
module ``tpu3d_torch.ops.deproject``."""

from tpu3d_torch.ops.depth import bilateral_filter, depth_preprocess
from tpu3d_torch.ops.fpfh import compute_fpfh
from tpu3d_torch.ops.icp import icp_refine
from tpu3d_torch.ops.neighbors import (
    knn,
    pairwise_sqdist,
    radius_capped_neighbors,
)
from tpu3d_torch.ops.nn import nearest_neighbor
from tpu3d_torch.ops.normals import estimate_normals
from tpu3d_torch.ops.ransac import feature_correspondences, ransac_registration
from tpu3d_torch.ops.transforms import (
    euler_xyz_to_matrix,
    invert_transform,
    kabsch,
    make_transform,
    matrix_to_rpy_zyx,
    transform_points,
)
from tpu3d_torch.ops.voxel import compact, voxel_downsample

__all__ = [
    "bilateral_filter",
    "compact",
    "compute_fpfh",
    "depth_preprocess",
    "estimate_normals",
    "euler_xyz_to_matrix",
    "feature_correspondences",
    "icp_refine",
    "invert_transform",
    "kabsch",
    "knn",
    "make_transform",
    "matrix_to_rpy_zyx",
    "nearest_neighbor",
    "pairwise_sqdist",
    "radius_capped_neighbors",
    "ransac_registration",
    "transform_points",
    "voxel_downsample",
]
