"""Map-scale localization, the pose graph, plane bundle adjustment and
their distribution over a process mesh: PyTorch port of
`aicp_mapping_tpu.parallel` (the mesh over `torch.distributed`, the two
sharded ICP layouts, the edge- and observation-sharded solvers, and the
map-sharded localizer)."""
from .ba import (  # noqa: F401
    PlaneBA,
    build_plane_ba,
    extract_planes,
    optimize_plane_ba,
    optimize_plane_ba_sharded,
    pad_observations,
)
from .localizer import ShardedMapLocalizer, morton_argsort_np  # noqa: F401
from .mesh import (  # noqa: F401
    Mesh,
    initialize_distributed,
    launch,
    make_mesh,
    make_mesh_2d,
)
from .posegraph import (  # noqa: F401
    PoseGraph,
    make_odometry_edges,
    optimize_pose_graph,
    optimize_pose_graph_sharded,
    pad_edges,
)
from .sharded_icp import (  # noqa: F401
    histogram_quantile,
    map_sharded_point_to_plane_icp,
    sharded_point_to_plane_icp,
)
