"""wire_host_ms.online: the port's `aicp.wire.voxel` spans (the host voxel
grid and int16 quantization of `wire_cloud`) in the traced window, ms a
frame."""
from portbench.metrics._program import ms_per_frame


def read(run):
    return ms_per_frame(run, "aicp.wire.voxel")
