"""step_prefilter_ms.online: the port's `aicp.step.prefilter` spans (the
frame step's prefilter: voxel grid, plane segmentation, normals) in the
traced window, ms a frame: the host's time in the stage, unsynchronised."""
from portbench.metrics._program import ms_per_frame


def read(run):
    return ms_per_frame(run, "aicp.step.prefilter")
