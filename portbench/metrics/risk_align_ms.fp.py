"""risk_align_ms.fp: the port's `aicp.risk.align` spans (the risk stage's
alignability: two clouds' voxel grids, kNN normals, label propagation,
box matching and the PCA) in the traced window, ms a frame."""
from portbench.metrics._program import ms_per_frame
from portbench.metrics._recorded import recorded

NAME = "aicp.risk.align"


def read(run):
    return ms_per_frame(run, NAME) if recorded(NAME) else None
