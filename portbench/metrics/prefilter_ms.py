"""prefilter_ms: the synchronised stage time of `fused._prefilter` (voxel
grid, hough prefilter with K2's moments), ms a frame, over the staged
frames."""
from portbench.metrics._spans import mean_ms


def read(run):
    return mean_ms(run, "_prefilter")
