from .pcd import read_cloud, read_pcd, viewpoint_to_pose, write_pcd  # noqa: F401
