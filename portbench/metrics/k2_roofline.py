"""k2_roofline: the least time the card could take for the traced frames'
radius moments (the hough prefilter's normals) over the device time of the
kernels that did it, %.

The work is the problem's (`roofline.moments_work`): every valid point's
neighbours within the normal radius, as the reference's moments of the
same cloud count them, and the cloud read and the moments written once.
The device time is that of the kernels named here in the traced window.
"""
from portbench import roofline
from portbench.trace import kernel_time_us

SCANS = ("moments_scan_kernel",)
MERGES = ("moments_merge_kernel",)


def read(run):
    if run.trace is None or not run.traced:
        return None
    if any(k not in run.neighbours for k in run.traced):
        return None
    rows = run.pipeline["downsample_capacity"]
    bound = sum(roofline.bound_s(*roofline.moments_work(
        rows, run.neighbours[k])) for k in run.traced)
    lo, hi = run.trace_window
    dev_us = kernel_time_us(run.trace.device_in(lo, hi), SCANS, MERGES)
    if dev_us <= 0.0:
        return None
    return bound / (dev_us * 1e-6) * 100.0
