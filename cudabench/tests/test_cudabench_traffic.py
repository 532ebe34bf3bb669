"""The traffic generator: one schedule per seed, the mix's statistics."""

import itertools

import numpy as np

from cudabench.traffic import Traffic, load, truncated_geometric


def test_same_seed_same_schedule():
    mix = load("bursty-8slot")
    a, b = (Traffic(mix, 2 ** 31 + 17, 20.0, 128257) for _ in range(2))
    c = Traffic(mix, 2 ** 31 + 18, 20.0, 128257)
    key = lambda t: [(s.due_s, s.frames, s.voice, s.seed, tuple(s.ids)) for s in t.sessions]
    assert key(a) == key(b)
    assert key(a) != key(c)
    # another seed: the same schedule (times, sizes), other contents
    sched = lambda t: [(s.due_s, s.frames, len(s.ids)) for s in t.sessions]
    assert sched(a) == sched(c)
    assert [tuple(s.ids) for s in a.sessions] != [tuple(s.ids) for s in c.sessions]


def test_open_loop_matches_the_mix():
    mix = load("bursty-8slot")
    seconds = 20.0
    t = Traffic(mix, 5, seconds, 128257)
    span = seconds + mix["lead_s"]
    n = len(t.sessions)
    assert abs(n / span - mix["rate"]) / mix["rate"] < 0.1
    starts = sorted({s.due_s for s in t.sessions})
    sizes = [sum(1 for s in t.sessions if s.due_s == x) for x in starts]
    assert min(sizes) >= mix["burst"]["lo"] and max(sizes) <= mix["burst"]["hi"]
    assert abs(np.mean(sizes) - mix["burst"]["mean"]) < 0.15
    assert max(s.due_s for s in t.sessions) < span
    lens = np.array([len(s.ids) for s in t.sessions])
    assert lens.min() >= mix["text_len"][0] and lens.max() <= mix["text_len"][1]
    assert abs(lens.mean() - np.mean(mix["text_len"])) < 5
    frames = np.array([s.frames for s in t.sessions])
    lo, hi = mix["frames"]
    assert frames.min() >= lo and frames.max() <= hi
    # log-uniform: the median is the geometric mean of the ends
    assert abs(np.median(frames) - np.sqrt(lo * hi)) / np.sqrt(lo * hi) < 0.05
    assert all(0 <= s.seed < 2 ** 31 for s in t.sessions)
    voices = np.bincount([s.voice for s in t.sessions], minlength=4) / n
    z = 1.0 / np.arange(1, 5) ** mix["refs"]["zipf"]
    assert np.abs(voices - z / z.sum()).max() < 0.03


def test_truncated_geometric_mean():
    p = truncated_geometric(1, 8, 2.5)
    assert abs((p * np.arange(1, 9)).sum() - 2.5) < 1e-6
    assert np.all(np.diff(p) < 0)


def test_closed_loop_clients():
    """A client sends without end, one cycle of sizes over and over, each
    session with contents of its own; what it sends depends on the seed
    alone, not on how far the other clients got."""
    mix = load("closed-16")
    t = Traffic(mix, 9, 20.0, 128257)
    c = mix["cycle"]
    assert len(t.clients) == mix["clients"]
    first = [list(itertools.islice(s, 10 * c)) for s in t.clients[:2]]
    assert all(len(f) == 10 * c for f in first)
    cycle = lambda f: sorted(s.frames for s in f[:c])
    assert cycle(first[0]) == cycle(first[1])
    assert [s.frames for s in first[0][:c]] != [s.frames for s in first[1][:c]]
    assert [s.frames for s in first[0][:c]] == [s.frames for s in first[0][9 * c:]]
    assert len({s.seed for s in first[0]}) == 10 * c
    assert tuple(first[0][0].ids) != tuple(first[0][c].ids)
    again = Traffic(mix, 9, 20.0, 128257)
    later = list(itertools.islice(again.clients[1], 10 * c))  # client 1 drawn first
    key = lambda f: [(s.frames, s.seed, tuple(s.ids)) for s in f]
    assert key(later) == key(first[1])
    single = Traffic(load("single-client"), 9, 20.0, 128257)
    assert {s.frames for s in itertools.islice(single.clients[0], 100)} == {400}
