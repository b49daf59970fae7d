"""Shared by the span readers: the mean of a host span, in ms."""


def mean_ms(run, name: str):
    vals = run.spans.get(name) or []
    if not vals:
        return None
    return sum(vals) / len(vals) * 1e3
