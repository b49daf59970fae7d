"""step_risk_ms.fp: the port's `aicp.step.risk` spans (the frame step's
failure-prediction stage: FOV overlap, alignability, the classifier) in
the traced window, ms a frame: the host's time in the stage,
unsynchronised, its label propagation's reads included."""
from portbench.metrics._program import ms_per_frame
from portbench.metrics._recorded import recorded

NAME = "aicp.step.risk"


def read(run):
    return ms_per_frame(run, NAME) if recorded(NAME) else None
