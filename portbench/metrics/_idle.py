"""Shared by device_idle.*: 1 - the union of the device's kernel, copy and
fill intervals over the traced window's wall span, in percent."""


def percent(run):
    if run.trace is None:
        return None
    lo, hi = run.trace_window
    if hi <= lo:
        return None
    return (1.0 - run.trace.busy_us(lo, hi) / (hi - lo)) * 100.0
