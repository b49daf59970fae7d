"""Configuration for the AICP pipeline: a pure-Python copy of the JAX
package's `pipeline.config` (same fields, same defaults, same YAML schema).
The field comments there explain each setting; options that drive paths not
ported yet are rejected by `App`.
"""
from __future__ import annotations

import dataclasses
import os

from ..registration.icp import ICPConfig


@dataclasses.dataclass
class PipelineConfig:
    # --- CommandLineConfig analog ---
    working_mode: str = "robot"            # "robot" | "debug"
    failure_prediction_mode: bool = False
    reference_update_frequency: int = 5
    max_correction_magnitude: float = 0.5  # meters per axis
    crop_map_around_base: float = 8.0
    load_map_from_file: bool = False
    localize_against_prior_map: bool = False
    localize_against_built_map: bool = False
    merge_aligned_clouds_to_map: bool = False
    verbose: bool = False
    debug_dir: str = ""

    # --- RegistrationParams ---
    sensor_range: float = 100.0
    sensor_angular_view: float = 360.0
    load_poses_from: str = ""
    initial_transform: str = ""

    # --- OverlapParams ---
    octree_resolution: float = 0.2

    # --- ClassificationParams ---
    risk_threshold: float = 0.50
    classifier_path: str = ""
    min_overlap_percent: float = 0.0

    # --- pre-filter ---
    voxel_size: float = 0.08
    prefilter_normal_k: int = 30
    graph_k: int = 15
    smoothness_deg: float = 3.0
    min_cluster_size: int = 50
    segmentation_method: str = "hough"
    normal_radius: float = 0.4

    pipeline_depth: int = 4

    # --- ICP chain ---
    icp: ICPConfig = dataclasses.field(default_factory=ICPConfig)
    icp_normal_k: int = 20
    trim_ratio_floor: float = 0.25
    trim_ratio_ceil: float = 0.70

    # --- static capacities ---
    raw_capacity: int = 131072
    downsample_capacity: int = 32768
    filtered_capacity: int = 8192
    map_capacity: int = 262144

    # --- wire format ---
    quantized_upload: bool = False
    wire_voxel: float = 0.0
    async_finalize: bool = False

    # --- alignability ---
    align_ds_capacity: int = 4096
    align_max_clusters: int = 32


def _parse_icp_dict(icp: dict, base: ICPConfig) -> ICPConfig:
    return dataclasses.replace(
        base,
        max_iterations=int(icp.get("maxIterationCount", base.max_iterations)),
        min_diff_trans=float(icp.get("minDiffTransErr", base.min_diff_trans)),
        min_diff_rot=float(icp.get("minDiffRotErr", base.min_diff_rot)),
        smooth_length=int(icp.get("smoothLength", base.smooth_length)),
        error_metric=str(icp.get("errorMetric", base.error_metric)),
        max_match_dist=float(icp.get("maxDist", base.max_match_dist)),
        trim_ratio=float(icp.get("trimRatio", base.trim_ratio)),
    )


def load_icp_chain_yaml(path: str, base: ICPConfig | None = None):
    """Parse one named ICP-chain YAML (configs/icp/*.yaml) into
    (ICPConfig, reading ChainFilterConfig, reference ChainFilterConfig)."""
    import yaml

    from ..registration.chain import ChainFilterConfig

    path = os.path.expandvars(os.path.expanduser(path))
    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    icp = doc.get("AICP", doc).get("ICP", {}) or {}

    def filters(d: dict) -> ChainFilterConfig:
        return ChainFilterConfig(
            min_dist=float(d.get("minDist", 0.0)),
            max_dist=float(d.get("maxDist", 0.0)),
            random_sampling_prob=float(d.get("randomSamplingProb", 1.0)),
            max_density_cell=float(d.get("maxDensityCell", 0.0)))

    return (_parse_icp_dict(icp, base or ICPConfig()),
            filters(icp.get("readingFilters", {}) or {}),
            filters(icp.get("referenceFilters", {}) or {}))


_PIPELINE_KEYS = (
    ("workingMode", "working_mode"),
    ("failurePredictionMode", "failure_prediction_mode"),
    ("referenceUpdateFrequency", "reference_update_frequency"),
    ("maxCorrectionMagnitude", "max_correction_magnitude"),
    ("cropMapAroundBase", "crop_map_around_base"),
    ("localizeAgainstPriorMap", "localize_against_prior_map"),
    ("localizeAgainstBuiltMap", "localize_against_built_map"),
    ("mergeAlignedCloudsToMap", "merge_aligned_clouds_to_map"),
    ("rawCapacity", "raw_capacity"),
    ("downsampleCapacity", "downsample_capacity"),
    ("filteredCapacity", "filtered_capacity"),
    ("mapCapacity", "map_capacity"),
    ("voxelSize", "voxel_size"),
    ("minClusterSize", "min_cluster_size"),
    ("segmentationMethod", "segmentation_method"),
    ("normalRadius", "normal_radius"),
)


def load_yaml_config(path: str,
                     base: PipelineConfig | None = None) -> PipelineConfig:
    """Parse the reference AICP YAML schema into a PipelineConfig."""
    import yaml

    cfg = dataclasses.replace(base) if base else PipelineConfig()
    path = os.path.expandvars(os.path.expanduser(path))
    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    aicp = doc.get("AICP", doc)

    reg = aicp.get("Registration", {}) or {}
    cfg.sensor_range = float(reg.get("sensorRange", cfg.sensor_range))
    cfg.sensor_angular_view = float(
        reg.get("sensorAngularView", cfg.sensor_angular_view))
    cfg.load_poses_from = str(reg.get("loadPosesFrom", cfg.load_poses_from)
                              or "")
    cfg.initial_transform = str(
        reg.get("initialTransform", cfg.initial_transform) or "")

    ob = (aicp.get("Overlap", {}) or {}).get("OctreeBased", {}) or {}
    cfg.octree_resolution = float(
        ob.get("octomapResolution", cfg.octree_resolution))

    svm = (aicp.get("Classifier", {}) or {}).get("SVM", {}) or {}
    cfg.risk_threshold = float(svm.get("threshold", cfg.risk_threshold))
    cfg.classifier_path = str(svm.get("saveFile", cfg.classifier_path) or "")

    icp = aicp.get("ICP", {}) or {}
    if icp:
        cfg.icp = _parse_icp_dict(icp, cfg.icp)
    pipe = aicp.get("Pipeline", {}) or {}
    for yaml_key, attr in _PIPELINE_KEYS:
        if yaml_key in pipe:
            setattr(cfg, attr, type(getattr(cfg, attr))(pipe[yaml_key]))
    return cfg
