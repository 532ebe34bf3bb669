"""Engine issue, CSM: the median over whole traced frames (a `csm.backbone`
span and the `csm.depth` span after it, `cudabench/spans_csm.py`) of the
launch rows (`cudaLaunchKernel*`, `cuLaunchKernel*`) that start between the
backbone span's start and the depth span's end."""

import statistics

from cudabench import spans_csm


def read(rec):
    got = spans_csm.frames(rec)
    if got is None or not got["frame"]:
        return None
    return float(statistics.median(n for *_, n in got["frame"]))
