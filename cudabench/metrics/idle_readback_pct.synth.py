"""Engine readback: the share of the covered stretch with the card idle while
a call's `sopro.readback` span is open: the pack, the one device->host copy
and the slice (`cudabench/spans.py`)."""

from cudabench import spans


def read(rec):
    s = spans.split(rec)
    return None if s is None else s["readback_pct"]
