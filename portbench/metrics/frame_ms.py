"""frame_ms: the window's wall time over the frames completed in it, ms
(host clock; closed-loop cells)."""
from portbench import stats


def read(run):
    w = run.window
    if w is None or not w.latencies:
        return None
    return stats.per_item_ms(w.start, w.end, len(w.latencies))
