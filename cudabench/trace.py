"""What the traced run keeps of `torch.profiler`: kernel intervals per
device and the host's operations, over a fixed stretch in the window's
middle, and the arithmetic the per-layer readers share.

Only device rows that are kernels, copies or sets count as busy (the
profiler's CUDA rows that are not user annotations); busy time is the union
of their intervals, so overlapping kernels count once.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

Interval = Tuple[str, float, float, int]  # name, start s, end s, device index


def collect(prof) -> Dict:
    """Kernel and host-op intervals (seconds, on the profiler's clock)."""
    from torch.autograd import DeviceType

    kernels: List[Interval] = []
    host: List[Tuple[str, float, float]] = []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue
            kernels.append((e.name, tr.start / 1e6, tr.end / 1e6, int(e.device_index)))
        else:
            host.append((e.name, tr.start / 1e6, tr.end / 1e6))
    return {"kernels": kernels, "host": host}


def union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_s(trace: Dict, device: Optional[int] = None) -> float:
    iv = [(a, b) for _, a, b, d in trace["kernels"] if device is None or d == device]
    return sum(b - a for a, b in union(iv))


def devices(trace: Dict) -> List[int]:
    return sorted({d for *_, d in trace["kernels"]})


def mean_busy_s(trace: Dict, cards: Optional[int] = None) -> float:
    """Busy seconds averaged over `cards` cards (default: those with a
    kernel in the trace)."""
    devs = devices(trace)
    n = cards or len(devs)
    return sum(busy_s(trace, d) for d in devs) / n if n else 0.0


def idle_pct(rec: Dict) -> Optional[float]:
    tr = rec.get("trace")
    if not tr or not tr["kernels"] or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - mean_busy_s(tr, int(rec["cell"]["chips"])) / tr["window_s"])


def kernel_s(trace: Dict, names: Tuple[str, ...]) -> float:
    return sum(b - a for n, a, b, _ in trace["kernels"] if any(k in n for k in names))


def breakdown(trace: Dict, top: int = 10) -> Dict:
    """The device operations that took most time, and the longest idle gaps
    named by the host operation that was running at the gap's middle."""
    by: Dict[str, float] = {}
    for n, a, b, _ in trace["kernels"]:
        by[n] = by.get(n, 0.0) + (b - a)
    ops = sorted(by.items(), key=lambda x: -x[1])[:top]
    busy = union([(a, b) for _, a, b, _ in trace["kernels"]])
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    host = sorted(trace["host"], key=lambda h: h[1])
    named = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inner = [h for h in host if h[1] <= mid <= h[2]]
        name = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "no host op"
        named.append([name, b - a])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
