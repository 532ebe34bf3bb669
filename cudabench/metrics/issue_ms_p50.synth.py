"""Engine issue: the median over whole traced calls of the host time from the
start of `sopro.synthesize` to the end of `sopro.ar`, by when K1 is on the
card's queue (`cudabench/spans.py`)."""

from cudabench import spans


def read(rec):
    s = spans.split(rec)
    return None if s is None else s["issue_ms_p50"]
