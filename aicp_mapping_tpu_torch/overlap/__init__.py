from .alignability import alignability_filter  # noqa: F401
from .fov import fov_overlap  # noqa: F401
from .voxel_overlap import OverlapStats, compute_overlap  # noqa: F401
