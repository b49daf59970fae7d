"""step_icp_ms.online: the port's `aicp.step.icp` spans (the frame step's
ICP, its host reads inside) in the traced window, ms a frame: the host's
time in the stage, unsynchronised."""
from portbench.metrics._program import ms_per_frame


def read(run):
    return ms_per_frame(run, "aicp.step.icp")
