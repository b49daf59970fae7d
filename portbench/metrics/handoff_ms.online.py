"""handoff_ms.online: the port's `aicp.app.flush` spans on the main thread
less the time inside them that the finalizer thread spends in its own
spans (the wait on the scalars, the state lock, the host tail): the handoff
between the two threads, in the traced window, ms a frame."""
from portbench.metrics._program import handoff_ms


def read(run):
    return handoff_ms(run)
