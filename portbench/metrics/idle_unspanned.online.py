"""idle_unspanned.online: the share of the traced window's device-idle time
in which no span of the port is open on any thread, %."""
from portbench.metrics._program import idle_unspanned


def read(run):
    return idle_unspanned(run)
