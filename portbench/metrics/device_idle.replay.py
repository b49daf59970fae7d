"""device_idle.replay: the device's idle share of the traced replay
window."""
from portbench.metrics._idle import percent


def read(run):
    return percent(run)
