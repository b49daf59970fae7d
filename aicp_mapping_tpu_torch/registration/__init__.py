from .chain import ChainFilterConfig, apply_chain_filters  # noqa: F401
from .icp import (  # noqa: F401
    ICPConfig,
    ICPResult,
    clamp_trim_ratio,
    degeneracy_predictions,
    point_to_plane_icp,
)
from .monitor import hausdorff_distance, residual_stats  # noqa: F401
