"""icp_sync_ms.online: the port's `aicp.icp.sync` and `aicp.icp.solve_check`
spans (ICP's blocking host reads: the convergence flag, and each
`torch.linalg` call with its error check) in the traced window, ms a
frame."""
from portbench.metrics._program import ms_per_frame

ICP_READS = ("aicp.icp.sync", "aicp.icp.solve_check")


def read(run):
    return ms_per_frame(run, ICP_READS)
