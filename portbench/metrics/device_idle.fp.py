"""device_idle.fp: the device's idle share of the traced window (closed
loop, failure prediction on)."""
from portbench.metrics._idle import percent


def read(run):
    return percent(run)
