"""icp_ms: the synchronised stage time of `point_to_plane_icp` (both
phases), ms a frame, over the staged frames."""
from portbench.metrics._spans import mean_ms


def read(run):
    return mean_ms(run, "point_to_plane_icp")
