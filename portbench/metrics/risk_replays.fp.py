"""risk_replays.fp: the count of the port's `aicp.risk.replay` spans (one
per replay of a captured piece of the risk stage,
`pipeline/risk_graph.py`) in the traced window, replays a frame: three
where the stage replays its graphs, 0 where it runs eagerly on the card.
None where the stage cannot be captured: a program without the captured
stage (no such module), or a run with no device work in its trace (the
CPU)."""
import importlib.util

from portbench.metrics._program import count_per_frame

NAME = "aicp.risk.replay"
MODULE = "aicp_mapping_tpu_torch.pipeline.risk_graph"


def read(run):
    if (importlib.util.find_spec(MODULE) is None or run.trace is None
            or not run.trace.device):
        return None
    return count_per_frame(run, NAME)
