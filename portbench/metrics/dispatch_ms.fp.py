"""dispatch_ms.fp: the port's `aicp.app.dispatch` spans (`App.submit_cloud`
dispatching the frame step, the risk stage inside it) in the traced
window, ms a frame."""
from portbench.metrics._program import ms_per_frame


def read(run):
    return ms_per_frame(run, "aicp.app.dispatch")
