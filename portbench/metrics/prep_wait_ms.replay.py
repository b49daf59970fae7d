"""prep_wait_ms.replay: the port's `aicp.runner.prep_wait` spans (the runner
waiting on its wire thread's next batch of clouds) in the traced replay
window, ms a frame."""
from portbench.metrics._program import ms_per_frame


def read(run):
    return ms_per_frame(run, "aicp.runner.prep_wait")
