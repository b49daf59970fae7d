from .oxts import (  # noqa: F401
    lat_to_scale,
    latlon_to_mercator,
    oxts_records_to_poses,
    read_oxts_directory,
)
from .pcd import read_cloud, read_pcd, viewpoint_to_pose, write_pcd  # noqa: F401
from .planar import (  # noqa: F401
    planar_to_cloud,
    read_planar_csv,
    synthetic_room_scan,
    write_planar_csv,
)
from .poses import (  # noqa: F401
    PoseWithTime,
    read_kitti_poses,
    read_pose_csv,
    write_kitti_poses,
    write_pose_csv,
)
