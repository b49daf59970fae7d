"""Shared by the readers of the port's risk-stage spans, which a program
may not have: a reader of `ms_per_frame` or `count_per_frame` returns
None, not 0, where the tracer's ring holds no span of the name."""
from portbench.metrics._program import ring


def recorded(name: str) -> bool:
    spans = ring()
    return bool(spans) and any(s.name == name for s in spans)
