"""Map-scale localization, the pose graph and plane bundle adjustment:
PyTorch port of the single-device part of `aicp_mapping_tpu.parallel`. The
mesh, the sharded ICP and the sharded solvers are ROADMAP Q1 #13
(`optimize_pose_graph_sharded` and `optimize_plane_ba_sharded` raise)."""
from .ba import (  # noqa: F401
    PlaneBA,
    build_plane_ba,
    extract_planes,
    optimize_plane_ba,
    optimize_plane_ba_sharded,
    pad_observations,
)
from .localizer import ShardedMapLocalizer, morton_argsort_np  # noqa: F401
from .posegraph import (  # noqa: F401
    PoseGraph,
    make_odometry_edges,
    optimize_pose_graph,
    optimize_pose_graph_sharded,
    pad_edges,
)
