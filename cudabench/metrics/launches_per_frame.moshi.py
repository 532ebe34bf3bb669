"""Engine issue, Moshi: the median over whole traced frames (a
`moshi.temporal` span and the `moshi.depth` span after it,
`cudabench/spans_moshi.py`) of the launch rows (`cudaLaunchKernel*`,
`cuLaunchKernel*`) that start between the temporal span's start and the
depth span's end."""

import statistics

from cudabench import spans_moshi


def read(rec):
    got = spans_moshi.frames(rec)
    if got is None:
        return None
    return float(statistics.median(n for *_, n in got["frame"]))
