"""host_reads.fp: device-to-host copies a frame in the device trace of the
traced frames (closed loop, failure prediction on)."""
from portbench.metrics._host_reads import per_frame


def read(run):
    return per_frame(run)
