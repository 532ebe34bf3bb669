"""Kernels K6 and K7, CSM's depth passes of a frame and its backbone step,
each one launch (`ops/csm_depth.py`, `csrc/csm_depth.cu`; `ops/csm_backbone.py`,
`csrc/csm_backbone.cu`), on one NVIDIA GPU at CSM-1B's widths, each beside
its plain version and the same work captured as one CUDA graph (the library
yardstick: cuBLAS, SDPA and PyTorch's own kernels, replayed with no host
issue), and its bound.

    python -m sopro_tpu_torch.bench_csm [--frames N] [--reps R] [--seed S] [--out PATH]
                                        [--clocks]

The weights, the audio table, the head and the codebook heads in float32
from a torch seed (N(0, 0.02), norms 1), TF32 off; the sampler at top-k 50
and temperature 0.9 on Gumbel noise. A reading is the CUDA-event time of N
frames (steps) back to back over N, after a warm-up; R readings of each in
turns (K6, graph, plain, graph, K6, ..., then K7 the same way), and their
medians. The depth weights (461 MB a pass) and the backbone's (3.9 GB a
step) never fit the 50 MB L2, so every pass and step reads them from HBM.
The bounds: the benchmark's bytes of a frame's depth passes
(`cudabench.flops_csm.depth_bytes`) and of a backbone step
(`backbone_bytes`, at the middle of the timed positions) over HBM's rate.
K7's steps run from a backbone cache prefilled eagerly to POSITIONS (300;
the cell's prompts are 209-329) and write the positions after it; its graph
replays one step at position 300.
Checks beside the times: K6's codes against the graph's on the same inputs
up to the first near-tie, K6's forced logits against the eager passes',
and a second K6 run bit for bit; K7's picks over 8 steps against the plain
step's up to the first near-tie (a score gap or top-k edge margin under
1e-4), its forced logits against the plain step's, and a second K7 run bit
for bit. `--clocks` builds K6's source again with -DSOPRO_CSM_CLOCKS
(`kernels.build_variant`, launched inside `kernels.using`) and reports, per
frame and block, the microseconds of each phase kind's input, slot waits,
products and grid barrier, the sampler's, and the producer's waits for a
free slot. Prints one JSON line and writes it to PATH (default
build/bench_csm.json).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import statistics
import subprocess
from pathlib import Path

import torch

from cudabench import flops, flops_csm
from sopro_tpu_torch import kernels
from sopro_tpu_torch import sampling as S
from sopro_tpu_torch.engine import configure_cuda_numerics
from sopro_tpu_torch.models.csm import CsmConfig, CsmModel, KVCache
from sopro_tpu_torch.ops.csm_backbone import BackboneKernel, step_plain
from sopro_tpu_torch.ops.csm_depth import DepthKernel, depth_plain

TEMPERATURE, TOP_K = 0.9, 50
POSITIONS, STEPS = 300, 8  # K7's prefilled cache, and the steps its checks compare
KINDS = ("proj", "qkv", "attn_o", "gate_up", "down", "head", "sample")
PARTS = ("input", "slot_wait", "rows", "barrier")


def csm_model(cfg: CsmConfig, dev, seed: int) -> CsmModel:
    """The parts of CSM the depth passes read, drawn on the device, then
    those the backbone step reads (its layers, final norm and `lm_head`);
    no text table."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev) * 0.02

    def layer(c, width):
        hd, f = c.head_dim, c.intermediate_size
        return {"ln1": torch.ones(width, device=dev), "ln2": torch.ones(width, device=dev),
                "qkv": rnd((c.num_attention_heads + 2 * c.num_key_value_heads) * hd, width),
                "o": rnd(width, c.num_attention_heads * hd), "gate_up": rnd(2 * f, width),
                "down": rnd(width, f)}
    c, b = cfg.depth, cfg.backbone
    d, D = c.hidden_size, b.hidden_size
    tree = {"audio_embed": rnd(cfg.num_codebooks * cfg.vocab_size, D),
            "depth": {"layers": [layer(c, d) for _ in range(c.num_hidden_layers)],
                      "norm": torch.ones(d, device=dev), "proj": rnd(d, D)},
            "heads": rnd(cfg.num_codebooks - 1, d, cfg.vocab_size)}
    tree["backbone"] = {"layers": [layer(b, D) for _ in range(b.num_hidden_layers)],
                        "norm": torch.ones(D, device=dev)}
    tree["lm_head"] = rnd(cfg.vocab_size, D)
    return CsmModel(tree, cfg)


def _flops_cfg(cfg: CsmConfig) -> dict:
    """`cfg` laid out as transformers' config.json (`CsmConfig.from_dict`'s
    input), as `cudabench.flops_csm` reads it."""
    return dict(dataclasses.asdict(cfg.backbone), num_codebooks=cfg.num_codebooks,
                vocab_size=cfg.vocab_size, depth_decoder_config=dataclasses.asdict(cfg.depth))


def bound_ms(cfg: CsmConfig) -> float:
    """The cell's bound of a frame's depth passes: `cudabench.flops_csm`'s
    bytes (each pass's depth weights, projector, embedding row, head slice
    and cache read once) over HBM's rate."""
    return 1e3 * flops_csm.depth_bytes(_flops_cfg(cfg)) / flops.PEAK_BYTES


def backbone_bound_ms(cfg: CsmConfig, ctx: int) -> float:
    """The cell's bound of one backbone step attending to `ctx` positions:
    `cudabench.flops_csm.backbone_bytes` (the layer weights, the final norm
    and the head once, the frame's embedding rows, the cache read over ctx
    positions and the new one written) over HBM's rate."""
    return 1e3 * flops_csm.backbone_bytes(_flops_cfg(cfg), ctx) / flops.PEAK_BYTES


class LibraryGraph:
    """`depth_plain` with its samples captured once as a CUDA graph over
    static inputs, replayed once a frame: the library kernels with no host
    issue."""

    def __init__(self, model, cache, noise: torch.Tensor):
        cfg, dev = model.cfg, model.device()
        self.h = torch.zeros((1, cfg.backbone.hidden_size), device=dev)
        self.c0 = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.noise = torch.zeros_like(noise[0])
        self.codes = torch.zeros((cfg.num_codebooks,), dtype=torch.int64, device=dev)
        pick = lambda i, x: S.sample_topk(x, self.noise[i: i + 1], TEMPERATURE, TOP_K)
        run = lambda: depth_plain(model, cache, self.h, self.c0, pick, self.codes)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            run()  # cuBLAS and SDPA set themselves up outside the capture
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            run()

    def __call__(self, h, c0, noise, out) -> None:
        self.h.copy_(h)
        self.c0.copy_(c0)
        self.noise.copy_(noise)
        self.graph.replay()
        out.copy_(self.codes)


def per_frame_ms(fn, frames: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for f in range(frames):
        fn(f)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / frames


class StepGraph:
    """`step_plain` (the eager backbone step with its sample) captured once
    as a CUDA graph at the cache's position `pos` over static inputs,
    replayed once a step: the library kernels with no host issue. Every
    replay writes position `pos` and attends to pos + 1 positions."""

    def __init__(self, model, cache, pos: int):
        cfg, dev = model.cfg, model.device()
        self.prev = torch.zeros((cfg.num_codebooks,), dtype=torch.int64, device=dev)
        self.noise = torch.zeros((cfg.vocab_size,), device=dev)
        self.h = torch.zeros((1, cfg.backbone.hidden_size), device=dev)
        self.c0 = torch.zeros((1,), dtype=torch.int64, device=dev)

        def run():
            cache.filled = pos
            step_plain(model, cache, self.prev, self.h, self.c0, noise=self.noise,
                       temperature=TEMPERATURE, top_k=TOP_K)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            run()  # cuBLAS and SDPA set themselves up outside the capture
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            run()

    def __call__(self, prev, noise) -> None:
        self.prev.copy_(prev)
        self.noise.copy_(noise)
        self.graph.replay()


def near_tie(logits: torch.Tensor, noise: torch.Tensor) -> bool:
    """A decision that float32 sums in another order may resolve either
    way: its kept top-two score gap or its top-k edge margin under 1e-4."""
    from cudabench.reference import csm as R

    _, gap, _, margin, _ = R.sample(logits[None], noise[None], TEMPERATURE, TOP_K)
    return min(float(gap[0]), float(margin[0])) < 1e-4


@torch.inference_mode()
def backbone_record(model, positions: int, frames: int, reps: int, seed: int) -> dict:
    """K7 on `model` (`csm_model`) from a backbone cache prefilled eagerly
    to `positions`: its picks over STEPS steps against `step_plain`'s on
    the same codes and noise up to the first near-tie, its forced logits,
    final norm and written cache rows against the plain step's (the
    largest error over the peak), a second run bit for bit; then, for
    `frames` > 0, ms a step of K7 (over `frames` steps from `positions`),
    of the plain step and of its CUDA graph (`StepGraph`) in `reps` turns,
    medians, and the bound at the timed positions' middle."""
    cfg, dev, steps = model.cfg, model.device(), STEPS
    q, v = cfg.num_codebooks, cfg.vocab_size
    cache = KVCache(cfg.backbone, cfg.backbone.max_position_embeddings, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    model.backbone(torch.randn((positions, cfg.backbone.hidden_size), generator=g, device=dev), cache)
    prevs = torch.randint(0, v, (steps, q), generator=g, device=dev)
    noise = -torch.log(-torch.log(torch.rand((steps, v), generator=g, device=dev).clamp_(1e-7, 1 - 1e-7)))
    kernel = BackboneKernel(model, cache)
    h, c0 = torch.zeros((1, cfg.backbone.hidden_size), device=dev), torch.zeros((1,), dtype=torch.int64, device=dev)
    span = slice(positions, positions + steps)

    def run(fn, **kw):
        """STEPS steps of fn from `positions`: picks [steps], logits
        [steps, V], h [steps, D], the written keys and values."""
        cache.filled = positions
        picks, logits, hs = [], torch.zeros((steps, v), device=dev), []
        for f in range(steps):
            forced = kw.get("forced")
            fn(model, cache, prevs[f], h, c0, logits=logits[f],
               **(dict(forced=forced[f: f + 1]) if forced is not None else
                  dict(noise=noise[f], temperature=TEMPERATURE, top_k=TOP_K)))
            picks.append(c0.clone())
            hs.append(h.clone())
        return (torch.cat(picks), logits, torch.cat(hs), cache.k[:, :, span].clone(),
                cache.v[:, :, span].clone())

    k7 = lambda *x, **kw: kernel(*x[2:], **kw)
    got, again, plain = run(k7), run(k7), run(step_plain)
    near = [near_tie(plain[1][f], noise[f]) for f in range(steps)]
    first = near.index(True) if True in near else steps
    forced_k7, forced_plain = run(k7, forced=plain[0]), run(step_plain, forced=plain[0])
    rel = lambda x, y: float((x - y).abs().max() / y.abs().max())
    out = {"positions": positions, "steps": steps, "picks_equal_until": first,
           "picks_equal": bool(torch.equal(got[0][:first], plain[0][:first])),
           "repeats": all(torch.equal(x, y) for x, y in zip(got, again)),
           "picks_are_sample_topk": all(
               int(S.sample_topk(got[1][f: f + 1].cpu(), noise[f: f + 1].cpu(), TEMPERATURE, TOP_K))
               == int(got[0][f]) for f in range(steps)),
           "forced_logits_rel_err": rel(forced_k7[1], forced_plain[1]),
           "forced_logits_max_abs_err": float((forced_k7[1] - forced_plain[1]).abs().max()),
           "h_rel_err": rel(forced_k7[2], forced_plain[2]),
           "cache_rel_err": max(rel(forced_k7[3], forced_plain[3]), rel(forced_k7[4], forced_plain[4]))}
    if frames < 1:
        return out
    graph = StepGraph(model, cache, positions)

    def timed(fn):
        def step(f):
            if f == 0:
                cache.filled = positions
            fn(f)
        return step
    runs = {
        "k7": timed(lambda f: kernel(prevs[f % steps], h, c0, noise=noise[f % steps], temperature=TEMPERATURE,
                                     top_k=TOP_K)),
        "graph": lambda f: graph(prevs[f % steps], noise[f % steps]),
        "plain": timed(lambda f: step_plain(model, cache, prevs[f % steps], h, c0, noise=noise[f % steps],
                                            temperature=TEMPERATURE, top_k=TOP_K)),
    }
    for fn in runs.values():  # warm-up
        per_frame_ms(fn, 3)
    times = {name: [] for name in runs}
    for _ in range(reps):
        for name in ("k7", "graph", "plain", "graph", "k7"):
            times[name].append(per_frame_ms(runs[name], frames if name != "plain" else 5))
    ms = {name: statistics.median(t) for name, t in times.items()}
    bound = backbone_bound_ms(cfg, positions + frames // 2)
    out.update(k7_ms=ms["k7"], graph_ms=ms["graph"], plain_ms=ms["plain"], k7_ms_all=times["k7"],
               graph_ms_all=times["graph"], bound_ms=bound, k7_share_pct=100.0 * bound / ms["k7"],
               graph_share_pct=100.0 * bound / ms["graph"],
               k7_gb_per_s=bound * flops.PEAK_BYTES / ms["k7"] / 1e9)
    return out


@torch.inference_mode()
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=Path("build/bench_csm.json"))
    ap.add_argument("--clocks", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_csm needs a CUDA device")
    configure_cuda_numerics()
    dev, cfg = torch.device("cuda", 0), CsmConfig()
    q, v = cfg.num_codebooks, cfg.vocab_size
    model = csm_model(cfg, dev, args.seed)
    cache = KVCache(cfg.depth, cfg.depth.max_position_embeddings, dev)
    kernel = DepthKernel(model, cache)
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    nf = 8
    noise = -torch.log(-torch.log(torch.rand((nf, q, v), generator=g, device=dev).clamp_(1e-7, 1 - 1e-7)))
    hs = torch.randn((nf, 1, cfg.backbone.hidden_size), generator=g, device=dev)
    c0s = torch.randint(0, 2048, (nf, 1), generator=g, device=dev)
    out = torch.zeros((q,), dtype=torch.int64, device=dev)
    graph = LibraryGraph(model, cache, noise)

    runs = {
        "k6": lambda f: kernel(hs[f % nf], c0s[f % nf], out, noise=noise[f % nf],
                               temperature=TEMPERATURE, top_k=TOP_K),
        "graph": lambda f: graph(hs[f % nf], c0s[f % nf], noise[f % nf], out),
        "plain": lambda f: depth_plain(model, cache, hs[f % nf], c0s[f % nf], lambda i, x: S.sample_topk(
            x, noise[f % nf, i: i + 1], TEMPERATURE, TOP_K), out),
    }
    # the checks: codes, forced logits, repeats
    codes = {}
    for name in ("k6", "graph"):
        got = []
        for f in range(nf):
            runs[name](f)
            got.append(out.clone())
        codes[name] = torch.stack(got)
    k6_again = []
    for f in range(nf):
        runs["k6"](f)
        k6_again.append(out.clone())
    same_frames = int((codes["k6"] == codes["graph"]).all(-1).sum())
    logits_err = 0.0
    for f in range(nf):
        forced = codes["graph"][f, 1:].contiguous()
        lg = torch.zeros((q - 1, v), device=dev)
        kernel(hs[f], c0s[f], out, forced=forced, logits=lg)
        want = []
        depth_plain(model, cache, hs[f], c0s[f], lambda i, x: (want.append(x[0]), forced[i - 1: i])[1], out)
        want = torch.stack(want)
        logits_err = max(logits_err, float((lg - want).abs().max() / want.abs().max()))

    for name in runs:  # warm-up
        per_frame_ms(runs[name], 3)
    times = {name: [] for name in runs}
    order = ("k6", "graph", "plain", "graph", "k6")
    for _ in range(args.reps):
        for name in order:
            times[name].append(per_frame_ms(runs[name], args.frames if name != "plain" else 5))
    ms = {name: statistics.median(t) for name, t in times.items()}
    clocks = None
    if args.clocks:
        lib = kernels.build_variant("csm_depth", defines=["-DSOPRO_CSM_CLOCKS"])
        with kernels.using("csm_depth", lib):
            per_frame_ms(runs["k6"], 3)
            buf = (ctypes.c_ulonglong * 40)()
            lib.sopro_csm_depth_clocks(buf)
            frame_ms = per_frame_ms(runs["k6"], args.frames)
            lib.sopro_csm_depth_clocks(buf)
        blocks = torch.cuda.get_device_properties(dev).multi_processor_count
        per = [x / (args.frames * blocks) for x in buf]
        mhz = per[29] / (frame_ms * 1e3)  # cycles of a launch over its microseconds
        us = lambda c: c / mhz
        clocks = {"frame_ms": frame_ms, "sm_mhz": mhz, "launch_us": us(per[29]),
                  "producer_wait_us": us(per[28]),
                  "last_arriver_barrier_us": us(buf[30] / max(buf[31], 1)) if buf[31] else None,
                  "attention_us": dict(zip(("cache_wait", "qkv_rope", "barrier", "compute"),
                                           (us(x) for x in per[32:36]))),
                  "phases_us": {k: {pt: us(per[4 * i + j]) for j, pt in enumerate(PARTS)}
                                for i, k in enumerate(KINDS)}}
    bound = bound_ms(cfg)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    result = {
        "device": torch.cuda.get_device_name(0), "card": card[:1], "torch": torch.__version__,
        "frames": args.frames, "reps": args.reps,
        "k6_ms": ms["k6"], "graph_ms": ms["graph"], "plain_ms": ms["plain"],
        "k6_ms_all": times["k6"], "graph_ms_all": times["graph"], "plain_ms_all": times["plain"],
        "bound_ms": bound, "k6_share_pct": 100.0 * bound / ms["k6"],
        "graph_share_pct": 100.0 * bound / ms["graph"],
        "k6_gb_per_s": bound * flops.PEAK_BYTES / ms["k6"] / 1e9,
        "codes_frames_equal_graph": same_frames, "codes_frames": nf,
        "k6_repeats": bool(torch.equal(torch.stack(k6_again), codes["k6"])),
        "forced_logits_rel_err": logits_err,
        "clocks": clocks, "clocks_ptxas": kernels.ptxas(lib) if args.clocks else None,
        "k7": backbone_record(model, POSITIONS, args.frames, args.reps, args.seed + 2),
        "k7_ptxas": kernels.ptxas("csm_backbone"),
    }
    line = json.dumps(result)
    print(line, flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
