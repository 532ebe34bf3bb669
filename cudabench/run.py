"""One run of one cell of the port's benchmark.

    python3 -m cudabench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from BENCHMARK.json (in the working directory), its
configuration from `cudabench/configs/<config>.json`, its traffic from
`cudabench/traffic/<mix>.json` and its check limits from
`cudabench/limits/<cell>.json`; the configuration's architecture is
`cudabench/families/<family>.py` and the program's entry the mix drives is
`cudabench/entries/<entry>.py`, each found by path in the checkout. Makes
the weights from the seed on the card, has the family build the program
(`sopro_tpu_torch`) from them through its checkpoint converters, warms up
the shapes the traffic uses, runs the traffic and measures for `--seconds`,
then checks what the program produced against the family's plain reference
and prints one JSON line. `--trace 1` runs the same with
`torch.profiler` over a fixed stretch in the window's middle and reports the
cell's per-layer metrics (`cudabench/metrics/<name>.py`) in place of the
end-to-end ones.

Exits 1 with no result line when the card or the cells' chip count is
missing, and 2 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

WAIT_AFTER_S = 60.0  # how long past the window's close a run waits for its sessions
TRACE_S = 3.0  # the profiled stretch: the window's last seconds
TRIES = 4  # near-ties tried at a divergence (cudabench.check)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # the checkout of this file


def cache_env(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(root, "build", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(root, "build", "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["HF_HUB_OFFLINE"] = "1"


def data_dir(root: str) -> str:
    """The benchmark's files in the checkout at `root`."""
    return os.path.join(root, "cudabench")


def load_cell(root: str, name: str):
    """The cell's entry, configuration, traffic mix and check limits, each
    found by its name."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    read = lambda *p: json.load(open(os.path.join(data_dir(root), *p)))
    return (bench, cell, read("configs", f"{cell['config']}.json"),
            read("traffic", f"{cell['traffic']}.json"), read("limits", f"{name}.json"))


class SeededTokenizer:
    """The text front end the harness hands the program: each text is a key
    whose token ids the traffic drew from the seed over the published
    vocabulary."""

    def __init__(self, vocab_size: int):
        self.vocab_size = int(vocab_size)
        self.table: Dict[str, np.ndarray] = {}

    def add(self, ids: np.ndarray) -> str:
        key = f"text-{len(self.table)}"
        self.table[key] = ids
        return key

    def encode(self, text: str):
        """A key's ids; any other text (the batcher's own warm-up) by its
        bytes."""
        if text in self.table:
            return [int(x) for x in self.table[text]]
        return [b % self.vocab_size for b in text.encode()]


# ----------------------------------------------------------------- traffic


class Record:
    """What the client saw of one session or request (host clock)."""

    def __init__(self, sess, text: str, due: float):
        self.sess = sess
        self.text = text
        self.due = due
        self.start: Optional[float] = None
        self.end: Optional[float] = None
        self.chunk_t: List[float] = []
        self.chunk_n: List[int] = []
        self.wav: List[np.ndarray] = []
        self.error: Optional[str] = None
        self.shard: Optional[int] = None


def bucket_texts(tts, mix: Dict) -> List[str]:
    """A text at each text bucket the mix's lengths reach, for warming up."""
    lo, hi = mix["text_len"]
    return [tts.tokenizer.add(np.ones((n,), np.int32))
            for n in sorted({min(max(x, lo), hi) for x in (16, 32, 64, 128, 256, lo, hi)})]


def load_module(root: str, kind: str, name: str):
    """`cudabench/<kind>/<name>.py` in the checkout at `root`, by path."""
    path = os.path.join(data_dir(root), kind, f"{name}.py")
    if name.startswith(".") or "/" in name or not os.path.isfile(path):
        raise ValueError(f"no {kind} {name!r}: {os.path.relpath(path, root)} is missing")
    mod_name = f"cudabench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_entry(root: str, name: str):
    """The entry module `cudabench/entries/<name>.py` a mix drives."""
    return load_module(root, "entries", name)


def load_family(root: str, cfg: Dict):
    """The family module `cudabench/families/<family>.py` the configuration
    names under "family"."""
    if "family" not in cfg:
        raise ValueError('the configuration names no "family" (cudabench/families/<family>.py)')
    return load_module(root, "families", cfg["family"])


# ----------------------------------------------------------------- metrics


def p95(xs: List[float]) -> Optional[float]:
    return float(np.percentile(np.asarray(xs, np.float64), 95)) if xs else None


def end_to_end(res: Dict, mix: Dict, seconds: float, sr: int) -> Dict:
    """The end-to-end metrics over the window, from the client's clocks, as
    the mix's entry in this checkout computes them."""
    return load_entry(ROOT, mix["entry"]).end_to_end(res, seconds, sr)


def load_reader(root: str, name: str):
    return load_module(root, "metrics", name).read


# ----------------------------------------------------------------- check


def pick_checked(res: Dict, mix: Dict, seed: int) -> List:
    """Finished kept sessions in the window, in an order drawn from the
    seed: the longest first, then one from each shard not yet among them (a
    mesh), then the rest spread evenly over their text lengths, the
    shortest and the longest text among them, so every text bucket the
    traffic reaches is checked."""
    w0, w1 = res["w0"], res["w1"]
    pool = [r for r in res["records"] if r.sess.keep and r.end is not None and r.error is None
            and w0 <= r.due < w1]
    if not pool:
        return []
    rng = np.random.default_rng((int(seed) + 7) & 0xFFFF_FFFF_FFFF)
    pool = [pool[int(i)] for i in rng.permutation(len(pool))]
    pool.sort(key=lambda r: -sum(r.chunk_n))
    picked, rest = [pool[0]], pool[1:]
    for r in rest:
        if r.shard is not None and r.shard not in {p.shard for p in picked}:
            picked.append(r)
    rest = sorted((r for r in rest if r not in picked), key=lambda r: len(r.sess.ids))
    want = int(mix["check"]["sessions"]) - len(picked)
    if want > 0 and rest:
        at = np.unique(np.rint(np.linspace(0, len(rest) - 1, min(want, len(rest)))).astype(int))
        picked += [rest[int(i)] for i in at]
    return picked[: int(mix["check"]["sessions"])]


# ----------------------------------------------------------------- main


def main(argv=None, device=None, root=None, cfg_override=None, keep=None) -> int:
    """A run; `device`, `root` and `cfg_override` let the harness's tests
    drive it on the CPU at a small size, and `keep` (a dict) receives what
    the check compared (`cudabench.control` reads it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    args = ap.parse_args(argv)
    root = root or os.getcwd()
    cache_env(root)
    bench, cell, cfg, mix, limits = load_cell(root, args.workload)
    if cfg_override:
        cfg, mix = cfg_override(cfg, mix)
    family = load_family(root, cfg)
    entry = load_entry(root, mix["entry"])

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print(f"needs {cell['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 1
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"

    from cudabench import FORBIDDEN, check, trace, weights
    from cudabench.traffic import Traffic

    state_dicts = weights.make(family.specs(cfg), args.seed, device)
    tok = SeededTokenizer(int(cfg["text_vocab"]))
    tts = family.build(cfg, state_dicts, device, tok)
    traffic = Traffic(mix, args.seed, args.seconds, int(cfg["text_vocab"]))
    voices = family.voices(traffic, cfg)
    sr = family.sample_rate(cfg)

    stamps: Dict[str, float] = {}
    traced: Dict = {}

    def setup_done():
        if args.trace and on_card:
            # CUPTI starts slowly the first time: start it here, in set-up
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                torch.zeros(1, device=device).add_(1)
                torch.cuda.synchronize()
        if on_card:
            torch.cuda.synchronize()
        stamps["setup"] = time.perf_counter() - T_START
        if on_card:
            for i in range(int(cell["chips"])):
                torch.cuda.reset_peak_memory_stats(i)

    def window(w0, w1, stats):
        """Sample the batcher's stats at the window's open, middle and close;
        a traced run profiles the window's last stretch and reads the
        profiler only after the close, so nothing it does runs in the
        window before that stretch."""
        out = {}
        time.sleep(max(0.0, w0 - time.perf_counter()))
        out["stats0"] = stats() if stats else None
        mid = 0.5 * (w0 + w1)
        time.sleep(max(0.0, mid - time.perf_counter()))
        out["stats_mid"] = stats() if stats else None
        prof = None
        if args.trace and on_card:
            from torch.profiler import ProfilerActivity, profile

            t_a = w1 - min(TRACE_S, 0.25 * args.seconds)
            time.sleep(max(0.0, t_a - time.perf_counter()))
            out["stats_pre"] = stats() if stats else None
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
            t_a = time.perf_counter()
            out["span"] = (w0, t_a)
        time.sleep(max(0.0, w1 - time.perf_counter()))
        out["stats1"] = stats() if stats else None
        if prof is not None:
            torch.cuda.synchronize()
            t_b = time.perf_counter()
            prof.stop()
            traced.update(trace.collect(prof), window_s=t_b - t_a)
        return out

    hooks = {"setup_done": setup_done, "window": window}
    res = entry.run(tts, mix, traffic, voices, args.seconds, hooks)
    e2e = entry.end_to_end(res, args.seconds, sr)
    attempted, failed = int(res["attempted"]), int(res["failed"])
    peak = 0
    if on_card:
        torch.cuda.synchronize()
        peak = max(torch.cuda.max_memory_allocated(i) for i in range(int(cell["chips"])))
    if res["batcher"] is not None:
        res["batcher"].stop()

    # the program's state is freed before the reference runs
    checked = family.checked(pick_checked(res, mix, args.seed), mix, voices)
    rec = {"cell": cell, "mix": mix, "cfg": cfg, "seconds": args.seconds,
           "stats0": res.get("stats0"), "stats_mid": res.get("stats_mid"),
           "stats1": res.get("stats1"), "records": res["records"],
           # what per-layer readers average over: the window, or in a traced run
           # its part before the profiled stretch, with the stats taken there
           "span": res.get("span", (res["w0"], res["w1"])),
           "stats_end": res.get("stats_pre") or res.get("stats1"),
           "w0": res["w0"], "w1": res["w1"], "hop": res["hop"], "sr": sr,
           "trace": traced or None, "flops": family.flops, "end_to_end": e2e}
    del tts, res
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    check.set_tf32(False)
    prec = check.Precision(torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" else torch.float32)
    reference = family.reference(state_dicts, cfg, prec, device, entry, mix)
    outs = reference.run(checked)
    outcome = check.judge(reference, checked, outs, float(limits["tau"]), float(limits["tie"]),
                          TRIES)
    held = check.within(outcome, limits)
    if keep is not None:
        keep.update(checked=checked, outs=outs, outcome=outcome, sd=state_dicts, cfg=cfg,
                    mix=mix, limits=limits, device=device, hop=reference.hop, entry=entry,
                    family=family, reference=reference,
                    stats_mid=rec["stats_mid"], stats1=rec["stats1"], end_to_end=e2e,
                    attempted=attempted, failed=failed)
    ok = bool(checked) and all(h for _, _, h in held.values()) and failed == 0

    if args.trace:
        metrics = {}
        for pm in bench["per_layer"]:
            if "workloads" in pm and cell["name"] not in pm["workloads"]:
                continue
            value = load_reader(root, pm["name"])(rec)
            if value is not None:
                metrics[pm["name"]] = {"value": float(value), "unit": pm["unit"]}
    else:
        metrics = {"setup_s": {"value": stamps["setup"], "unit": "s"}}
        for em in bench["end_to_end"]:
            if em["name"] in e2e and ("workloads" not in em or cell["name"] in em["workloads"]):
                metrics[em["name"]] = {"value": float(e2e[em["name"]]), "unit": em["unit"]}

    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 2

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    line = {"correct": ok, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device_info}
    if args.trace and traced:
        device_info["busy_s"] = trace.mean_busy_s(traced, int(cell["chips"]))
        device_info["window_s"] = traced["window_s"]
        line["breakdown"] = trace.breakdown(traced)
    numbers = {k: {"value": v, "limit": lim} for k, (v, lim, _) in held.items()}
    numbers["sessions_checked"] = {"value": len(checked), "limit": 1}
    numbers["failed"] = {"value": failed, "limit": 0}
    line["checked"] = numbers
    flips = [g for p in outcome.sessions for g in p["flips"]]
    print(f"near-ties followed {len(flips)}, largest gap {max(flips, default=0.0):.3g}",
          file=sys.stderr)
    for i, p in enumerate(outcome.sessions):
        if not p["explained"]:  # per divergence: its frame, each try [gap, kind, moved to]
            print(f"unexplained: checked call {i} of {p['frames']} frames, "
                  f"{json.dumps(p['trail'])}", file=sys.stderr)
    for k, (v, lim, h) in held.items():
        print(f"check {k} {v:.6g} limit {lim:.6g} {'held' if h else 'FAILED'}", file=sys.stderr)
    print(f"check sessions_checked {len(checked)} limit 1", file=sys.stderr)
    print(f"check failed {failed} limit 0", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
