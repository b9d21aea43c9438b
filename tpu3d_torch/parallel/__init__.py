"""Multi-device registration: meshes, sharded NN search, the halo-exchange
prepare, sharded RANSAC and ICP, and the instance batch (one controller,
``parallel/mesh.py``)."""

from tpu3d_torch.parallel.batched import (
    register_batch,
    shard_instances,
    stack_clouds,
)
from tpu3d_torch.parallel.icp_sharded import icp_refine_sharded
from tpu3d_torch.parallel.mesh import make_mesh, replicated, row_sharded
from tpu3d_torch.parallel.ransac_sharded import (
    feature_correspondences_sharded,
    ransac_registration_sharded,
)
from tpu3d_torch.parallel.register_sharded import (
    parallel_mesh,
    prepare_features_sharded,
    register_pair_sharded,
    register_prepared_sharded,
)
from tpu3d_torch.parallel.sharded_nn import (
    build_walk_sharded,
    nearest_neighbor_sharded,
    slab2_top1_sharded,
)

__all__ = [
    "build_walk_sharded",
    "feature_correspondences_sharded",
    "icp_refine_sharded",
    "make_mesh",
    "nearest_neighbor_sharded",
    "parallel_mesh",
    "prepare_features_sharded",
    "ransac_registration_sharded",
    "register_batch",
    "register_pair_sharded",
    "register_prepared_sharded",
    "replicated",
    "row_sharded",
    "shard_instances",
    "slab2_top1_sharded",
    "stack_clouds",
]
