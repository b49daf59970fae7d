"""lock_wait_ms.replay: the port's `aicp.app.lock_wait` spans on the main
thread (`submit_cloud` or `flush` blocked on the App's state lock, which the
finalizer holds through a batch's bookkeeping) in the traced replay window,
ms a frame."""
from portbench.metrics._program import MAIN, ms_per_frame


def read(run):
    return ms_per_frame(run, "aicp.app.lock_wait", MAIN)
