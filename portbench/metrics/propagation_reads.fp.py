"""propagation_reads.fp: the count of the port's
`aicp.seg.propagation_read` spans (one per host read of label
propagation's convergence flag, `ops/segmentation.py`) in the traced
window, reads a frame."""
from portbench.metrics._program import count_per_frame
from portbench.metrics._recorded import recorded

NAME = "aicp.seg.propagation_read"


def read(run):
    return count_per_frame(run, NAME) if recorded(NAME) else None
