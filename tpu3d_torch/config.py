"""Registration configuration: the ``tpu3d.config.RegistrationConfig``
fields that ``register_pair`` reads, with the same names and defaults.

The YAML loader and the pipeline/camera/robot sections stay in the JAX
package until the pipeline is ported.
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
    min_fitness: float = 0.3
    # Exactness knobs of the at-scale statistical paths (see the JAX
    # config): 'auto'|'exact'|'subsample' for corr_mode/src_mode,
    # 'auto'|'on'|'off' for two_stage, 'auto'|'dense'|'sparse' for
    # prepare_mode.
    corr_mode: str = "auto"
    src_mode: str = "auto"
    two_stage: str = "auto"
    prepare_mode: str = "auto"
    # The sparse arm re-runs through the dense arm below this refined
    # fitness; 0 disables it, 'auto' reads min_fitness.
    sparse_escalate_fitness: float | str = "auto"
