"""Device: the share of the profiled stretch with no kernel, copy or set on
the card (the union of the profiler's device intervals), averaged over the
cards the cell uses."""

from cudabench import trace


def read(rec):
    return trace.idle_pct(rec)
