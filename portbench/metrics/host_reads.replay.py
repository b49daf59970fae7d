"""host_reads.replay: device-to-host copies a frame in the device trace of
the traced replay frames."""
from portbench.metrics._host_reads import per_frame


def read(run):
    return per_frame(run)
