"""step_overlap_ms.online: the port's `aicp.step.overlap` spans (the frame
step's voxel overlap) in the traced window, ms a frame: the host's time in
the stage, unsynchronised."""
from portbench.metrics._program import ms_per_frame


def read(run):
    return ms_per_frame(run, "aicp.step.overlap")
