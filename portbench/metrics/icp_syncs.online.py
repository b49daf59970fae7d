"""icp_syncs.online: the count of the port's `aicp.icp.sync` and
`aicp.icp.solve_check` spans (one per host read in ICP: the convergence
flag's, and each `torch.linalg` call's error check) in the traced window,
syncs a frame."""
from portbench.metrics._program import count_per_frame

ICP_READS = ("aicp.icp.sync", "aicp.icp.solve_check")


def read(run):
    return count_per_frame(run, ICP_READS)
