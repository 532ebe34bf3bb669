"""Caller: the share of the covered stretch (the first whole traced call's
start to the last one's end) with no kernel, copy or set on the card and no
`SoproTTS.synthesize` call open (`cudabench/spans.py`)."""

from cudabench import spans


def read(rec):
    s = spans.split(rec)
    return None if s is None else s["caller_pct"]
