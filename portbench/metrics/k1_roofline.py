"""k1_roofline: the least time the card could take for the traced frames'
1-NN matching over the device time of the kernels that did it, %.

The work is the problem's (`roofline.nn_work`): each ICP iteration matches
every valid query of its phase against every valid point of the frame's
reference cloud. The phases and their iterations are those the solver ran
(recorded per frame, `drivers.Driver.traced`), else the frame's
`n_iterations` at the full reading; the valid counts are the frames'
`filtered_size`, the coarse phase's the valid rows of its stride. The
device time is that of the kernels named here in the traced window.
"""
import math

from portbench import roofline
from portbench.drivers import phases_of
from portbench.trace import kernel_time_us

SCANS = ("nn_scan_kernel",)
MERGES = ("merge_kernel",)


def read(run):
    if run.trace is None or not run.traced:
        return None
    cap = run.pipeline["filtered_capacity"]
    bound = 0.0
    for k in run.traced:
        res = run.results[k]
        ref = run.results[run.schedule[k]]
        for rows, its in phases_of(run.icp_calls.get(k, []),
                                   res.n_iterations, cap):
            stride = cap // rows
            ops, nbytes = roofline.nn_work(
                rows, math.ceil(res.filtered_size / stride), cap,
                ref.filtered_size, its)
            bound += roofline.bound_s(ops, nbytes)
    lo, hi = run.trace_window
    dev_us = kernel_time_us(run.trace.device_in(lo, hi), SCANS, MERGES)
    if dev_us <= 0.0:
        return None
    return bound / (dev_us * 1e-6) * 100.0
