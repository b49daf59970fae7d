"""dispatch_ms.replay: the port's `aicp.app.dispatch` spans on the main
thread in the traced replay window, ms a frame."""
from portbench.metrics._program import MAIN, ms_per_frame


def read(run):
    return ms_per_frame(run, "aicp.app.dispatch", MAIN)
