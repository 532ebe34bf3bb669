"""Engine issue: the median over whole traced calls of the launch rows
(`cudaLaunchKernel*`, `cuLaunchKernel*`) in the trace's host rows that start
inside the call's mapped `sopro.synthesize` span (`cudabench/spans.py`)."""

from cudabench import spans


def read(rec):
    s = spans.split(rec)
    return None if s is None else s["launches_per_call"]
