"""device_idle.online: the device's idle share of the traced window."""
from portbench.metrics._idle import percent


def read(run):
    return percent(run)
