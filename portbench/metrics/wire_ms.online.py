"""wire_ms.online: the host clock around each `wire_cloud` call of the
staged frames (host voxel grid, int16 quantization, upload), ms a cloud."""
from portbench.metrics._spans import mean_ms


def read(run):
    return mean_ms(run, "wire_cloud")
