"""Pipeline configuration: the ``PipelineConfig`` tree and its YAML loader.

Counterpart of ``tpu3d/config.py``, with the same fields, defaults and
parse-failure behaviour (any error while reading the file gives an
all-defaults config). It mirrors the reference's ``PipelineConfig`` struct
(include/pipeline_config.hpp:11-68) and loader (src/main.cpp:10-78):
  - ``ransac_confidence``, ``icp_distance_factor`` and ``use_point_to_plane``
    are parsed when present (the reference only ever uses their defaults);
  - ``clipping_min`` and ``camera.ip`` are kept for config-file
    compatibility and never read;
  - ``depth.bilateral_filter`` is live and enables
    :func:`tpu3d_torch.ops.depth.bilateral_filter`;
  - ``registration.sparse_escalate_fitness`` is not read from YAML, as in
    the JAX loader: only its default ('auto') applies to a loaded file.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import numpy as np

try:
    import yaml

    _HAS_YAML = True
except Exception:  # pragma: no cover - yaml is expected to exist
    _HAS_YAML = False


@dataclasses.dataclass
class CameraConfig:
    width: int = 1280
    height: int = 720
    ip: str = ""  # never read by the reference either (pipeline_config.hpp:14)


@dataclasses.dataclass
class DepthConfig:
    scale_to_meters: float = 1000.0
    clipping_min: float = 0.1  # unused in reference; kept for parity
    clipping_max: float = 1.5
    bilateral_filter: bool = False
    bilateral_sigma_spatial: float = 2.0  # extension: live bilateral params
    bilateral_sigma_range: float = 0.05


@dataclasses.dataclass
class RegistrationConfig:
    voxel_size: float = 0.001
    ransac_max_iterations: int = 100000
    ransac_confidence: float = 0.999
    icp_distance_factor: float = 0.4
    icp_max_iterations: int = 200
    min_fitness: float = 0.3
    use_point_to_plane: bool = True
    # No reference analog: a fixed capacity bucket for the downsampled
    # clouds. 0 = auto (next power-of-two-ish from data).
    max_points: int = 0
    ransac_seed: int = 42  # analog of std::mt19937 rng(42), registration.cpp:235
    # Exactness knobs for the at-scale statistical fast paths (an
    # extension — the reference is always exact). 'auto' enables strided
    # subsampling above the size gates (documented σ in ops/ransac.py and
    # ops/icp.py); 'exact' reproduces reference-exact fitness/rmse
    # (registration.cpp:216-232, 321-339) at full cost; 'subsample'
    # forces the subset path where applicable.
    corr_mode: str = "auto"  # RANSAC correspondences: auto|exact|subsample
    src_mode: str = "auto"  # ICP source rows: auto|exact|subsample
    two_stage: str = "auto"  # RANSAC two-stage scoring: auto|on|off
    # Source descriptor prepare: 'sparse' computes normals+FPFH only for
    # the blocks the correspondence subset needs (every retained
    # descriptor exact — ops/fused_features.fused_prepare_sparse); 'auto'
    # enables it on a CUDA device at the same scale gate where
    # corr_mode='auto' would subsample anyway, so reported metrics stay in
    # the same statistical class. 'dense' always prepares every row.
    prepare_mode: str = "auto"  # auto|dense|sparse
    # Sparse-arm escalation (host-level restart): when the sparse-prepare
    # pipeline's refined fitness lands below this threshold — i.e. the
    # result the min_fitness warning would reject anyway — re-run the
    # coarse+refine stages through the full-prepare corr_mode='auto' arm
    # and keep the better result. On noisy scenes the sparse subset's
    # 4-run strata occasionally miss the basin the row-strided subset
    # finds (AB_STATS r5 seeds 5/7/19); clean scenes never trigger it.
    # 0 disables. 'auto' (default) uses min_fitness.
    sparse_escalate_fitness: float | str = "auto"


@dataclasses.dataclass
class ParallelConfig:
    """Multi-device routing (an extension — the reference is single-GPU).
    ``mode`` 'on' or 'auto' makes ``Pipeline`` build a 1-D mesh over
    ``devices`` devices (0: every visible one; fewer than 2 runs
    single-device) and route every registration through the sharded stack
    with a ``halo``-row prepare strip (0: the radius-aware default)."""

    mode: str = "off"  # off|on|auto
    devices: int = 0
    halo: int = 0


@dataclasses.dataclass
class RobotConfig:
    ip: str = "192.168.1.184"
    speed: int = 80
    approach_offset_z: float = -0.101


@dataclasses.dataclass
class SegmentationConfig:
    sam_server_url: str = ""
    sam_query: str = (
        "Segment the circular grey metallic caps,1 instance at a time, in order"
    )
    masks_input_dir: str = ""
    apply_mask: bool = True


@dataclasses.dataclass
class PipelineConfig:
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    depth: DepthConfig = dataclasses.field(default_factory=DepthConfig)
    registration: RegistrationConfig = dataclasses.field(
        default_factory=RegistrationConfig
    )
    parallel: ParallelConfig = dataclasses.field(
        default_factory=ParallelConfig
    )
    robot: RobotConfig = dataclasses.field(default_factory=RobotConfig)
    segmentation: SegmentationConfig = dataclasses.field(
        default_factory=SegmentationConfig
    )
    reference_model_path: str = ""
    use_camera: bool = True
    use_robot: bool = True
    dummy_rgb_path: str = ""
    dummy_depth_path: str = ""
    num_threads: int = 8
    use_gpu: bool = True  # reference flag name kept; here it means "use accelerator"
    visualization: str = "opengl"  # "opengl" (mapped to the bundled viewer) or "none"
    camera_extrinsics: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )


def load_config(path: Optional[str] = None) -> PipelineConfig:
    """Load a YAML config, mirroring src/main.cpp:10-78.

    Missing keys get the reference defaults; any parse failure returns an
    all-defaults config (main.cpp:73-75).
    """
    config = PipelineConfig()
    if path is None:
        return config
    if not _HAS_YAML:
        print("Config error: PyYAML unavailable — using defaults", file=sys.stderr)
        return config
    try:
        with open(path) as f:
            y = yaml.safe_load(f) or {}

        def get(node, key, default):
            v = node.get(key, default) if isinstance(node, dict) else default
            return default if v is None else v

        cam = y.get("camera") or {}
        if "camera" in y:
            config.camera.width = int(get(cam, "width", 1280))
            config.camera.height = int(get(cam, "height", 720))
            config.camera.ip = str(get(cam, "ip", ""))

        dep = y.get("depth") or {}
        if "depth" in y:
            config.depth.scale_to_meters = float(get(dep, "scale_to_meters", 1000.0))
            config.depth.clipping_min = float(get(dep, "clipping_min", 0.1))
            config.depth.clipping_max = float(get(dep, "clipping_max", 1.5))
            config.depth.bilateral_filter = bool(get(dep, "bilateral_filter", False))
            config.depth.bilateral_sigma_spatial = float(
                get(dep, "bilateral_sigma_spatial", 2.0)
            )
            config.depth.bilateral_sigma_range = float(
                get(dep, "bilateral_sigma_range", 0.05)
            )

        reg = y.get("registration") or {}
        if "registration" in y:
            config.registration.voxel_size = float(get(reg, "voxel_size", 0.001))
            config.registration.ransac_max_iterations = int(
                get(reg, "ransac_max_iterations", 100000)
            )
            config.registration.ransac_confidence = float(
                get(reg, "ransac_confidence", 0.999)
            )
            config.registration.icp_distance_factor = float(
                get(reg, "icp_distance_factor", 0.4)
            )
            config.registration.icp_max_iterations = int(
                get(reg, "icp_max_iterations", 200)
            )
            config.registration.min_fitness = float(get(reg, "min_fitness", 0.3))
            config.registration.use_point_to_plane = bool(
                get(reg, "use_point_to_plane", True)
            )
            config.registration.max_points = int(get(reg, "max_points", 0))
            config.registration.ransac_seed = int(get(reg, "ransac_seed", 42))
            config.registration.corr_mode = str(get(reg, "corr_mode", "auto"))
            config.registration.src_mode = str(get(reg, "src_mode", "auto"))
            ts = get(reg, "two_stage", "auto")
            if isinstance(ts, bool):  # YAML 1.1 reads on/off as booleans
                ts = "on" if ts else "off"
            config.registration.two_stage = str(ts)
            config.registration.prepare_mode = str(
                get(reg, "prepare_mode", "auto")
            )

        par = y.get("parallel") or {}
        if "parallel" in y:
            pm = str(get(par, "mode", "off"))
            # YAML 1.1 reads bare on/off as booleans.
            if isinstance(get(par, "mode", "off"), bool):
                pm = "on" if get(par, "mode", "off") else "off"
            config.parallel.mode = pm
            config.parallel.devices = int(get(par, "devices", 0))
            config.parallel.halo = int(get(par, "halo", 0))

        rob = y.get("robot") or {}
        if "robot" in y:
            config.robot.ip = str(get(rob, "ip", "192.168.1.184"))
            config.robot.speed = int(get(rob, "speed", 80))
            config.robot.approach_offset_z = float(
                get(rob, "approach_offset_z", -0.101)
            )

        seg = y.get("segmentation") or {}
        if "segmentation" in y:
            config.segmentation.sam_server_url = str(get(seg, "sam_server_url", ""))
            config.segmentation.sam_query = str(
                get(
                    seg,
                    "sam_query",
                    "Segment the circular grey metallic caps,1 instance at a time,"
                    " in order",
                )
            )
            config.segmentation.masks_input_dir = str(get(seg, "masks_input_dir", ""))
            config.segmentation.apply_mask = bool(get(seg, "apply_mask", True))

        config.reference_model_path = str(get(y, "reference_model_path", ""))
        config.use_camera = bool(get(y, "use_camera", True))
        config.use_robot = bool(get(y, "use_robot", True))

        dummy = y.get("dummy_data") or {}
        if "dummy_data" in y:
            config.dummy_rgb_path = str(get(dummy, "rgb_path", ""))
            config.dummy_depth_path = str(get(dummy, "depth_path", ""))

        config.num_threads = int(get(y, "num_threads", 8))
        config.use_gpu = bool(get(y, "use_gpu", True))
        viz = str(get(y, "visualization", "opengl"))
        config.visualization = "none" if viz == "none" else "opengl"

        ext = y.get("camera_extrinsics")
        if isinstance(ext, list) and len(ext) == 16:
            config.camera_extrinsics = np.asarray(ext, dtype=np.float32).reshape(4, 4)

        print(f"Config loaded from {path}")
    except Exception as e:  # matches reference catch-all → defaults
        print(f"Config error: {e} — using defaults", file=sys.stderr)
        return PipelineConfig()
    return config
