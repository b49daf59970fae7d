"""scans_per_s: the frames whose results came back inside the window, over
the window (host clock; replay cells): the count of `App.frames` at the
window's end less that at its start, over the time between."""
from portbench import stats


def read(run):
    w = run.window
    if w is None or w.end <= w.start or not w.frames:
        return None
    return stats.rate(w.completed, w.start, w.end)
