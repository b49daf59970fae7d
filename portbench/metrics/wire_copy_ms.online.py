"""wire_copy_ms.online: the port's `aicp.wire.upload` spans (the copies to
the device and the dequantize of `wire_cloud`) in the traced window, ms a
frame."""
from portbench.metrics._program import ms_per_frame


def read(run):
    return ms_per_frame(run, "aicp.wire.upload")
