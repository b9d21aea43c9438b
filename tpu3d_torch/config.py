"""Registration configuration: the ``tpu3d.config.RegistrationConfig``
fields that ``register_pair`` reads, with the same names and defaults.

The YAML loader, the pipeline/camera/robot sections and the sparse-arm
knobs stay in the JAX package until the pipeline is ported.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RegistrationConfig:
    voxel_size: float = 0.001
    ransac_max_iterations: int = 100000
    ransac_confidence: float = 0.999
    icp_distance_factor: float = 0.4
    icp_max_iterations: int = 200
    use_point_to_plane: bool = True
    ransac_seed: int = 42
    # Exactness knobs of the at-scale statistical paths (see the JAX
    # config): 'auto'|'exact'|'subsample' for corr_mode/src_mode,
    # 'auto'|'on'|'off' for two_stage, 'auto'|'dense'|'sparse' for
    # prepare_mode.
    corr_mode: str = "auto"
    src_mode: str = "auto"
    two_stage: str = "auto"
    prepare_mode: str = "auto"
