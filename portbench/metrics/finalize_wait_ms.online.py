"""finalize_wait_ms.online: the port's `aicp.app.finalize_wait` spans on the
App's finalizer thread (the wait on a batch's scalars) in the traced
window, ms a frame."""
from portbench.metrics._program import FINALIZER, ms_per_frame


def read(run):
    return ms_per_frame(run, "aicp.app.finalize_wait", FINALIZER)
