"""icp_replays.online: the count of the port's `aicp.icp.replay` spans (one
per replay of ICP's captured iteration, `registration/icp.py`) in the
traced window, replays a frame. Equal to `icp_iterations` where every ICP
iteration is a replay; 0 where ICP runs its eager loop."""
from portbench.metrics._program import count_per_frame


def read(run):
    return count_per_frame(run, "aicp.icp.replay")
