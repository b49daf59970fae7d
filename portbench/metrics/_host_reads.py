"""Shared by host_reads.*: device-to-host copies in the traced window over
the frames traced."""


def per_frame(run):
    if run.trace is None or not run.traced:
        return None
    lo, hi = run.trace_window
    n = sum(1 for e in run.trace.device_in(lo, hi)
            if e.cat == "gpu_memcpy" and "DtoH" in e.name)
    return n / len(run.traced)
