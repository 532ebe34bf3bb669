"""Engine issue: the share of the covered stretch with the card idle while a
`SoproTTS.synthesize` call is open in any step but `sopro.readback`
(`cudabench/spans.py`)."""

from cudabench import spans


def read(rec):
    s = spans.split(rec)
    return None if s is None else s["issue_pct"]
