"""Kernel K6, a frame of CSM's depth passes in one launch (`ops/csm_depth.py`,
`csrc/csm_depth.cu`), on one NVIDIA GPU at CSM-1B's widths, beside its plain
version and the same passes captured as one CUDA graph (the library
yardstick: cuBLAS, SDPA and PyTorch's own kernels, replayed with no host
issue), and the bound.

    python -m sopro_tpu_torch.bench_csm [--frames N] [--reps R] [--seed S] [--out PATH]
                                        [--clocks]

The depth decoder's weights, the audio table and the heads in float32 from a
torch seed (N(0, 0.02), norms 1), TF32 off; the sampler at top-k 50 and
temperature 0.9 on Gumbel noise. A reading is the CUDA-event time of N
frames back to back over N, after a warm-up; R readings of each in turns
(K6, graph, plain, graph, K6, ...), and their medians. The weights, 461 MB a
pass, never fit the 50 MB L2, so every pass reads them from HBM. The bound
(`bound_ms`): the benchmark's bytes of a frame's passes
(`cudabench.flops_csm.depth_bytes`) over its HBM rate.
Checks beside the times: K6's codes against the graph's on the same inputs
up to the first near-tie, K6's forced logits against the eager passes',
and a second K6 run bit for bit. `--clocks` builds the source again with
-DSOPRO_CSM_CLOCKS (`kernels.build_variant`, launched inside
`kernels.using`) and reports, per frame and block, the microseconds of
each phase kind's input, slot waits, products and grid barrier, the
sampler's, and the producer's waits for a free slot. Prints one JSON line
and writes it to PATH (default build/bench_csm.json).
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
from sopro_tpu_torch.ops.csm_depth import DepthKernel, depth_plain

TEMPERATURE, TOP_K = 0.9, 50
KINDS = ("proj", "qkv", "attn_o", "gate_up", "down", "head", "sample")
PARTS = ("input", "slot_wait", "rows", "barrier")


def depth_model(cfg: CsmConfig, dev, seed: int) -> CsmModel:
    """The parts of CSM the depth passes read, drawn on the device."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev) * 0.02
    c = cfg.depth
    d, D, F, hd = c.hidden_size, cfg.backbone.hidden_size, c.intermediate_size, c.head_dim
    layer = lambda: {"ln1": torch.ones(d, device=dev), "ln2": torch.ones(d, device=dev),
                     "qkv": rnd((c.num_attention_heads + 2 * c.num_key_value_heads) * hd, d),
                     "o": rnd(d, c.num_attention_heads * hd), "gate_up": rnd(2 * F, d),
                     "down": rnd(d, F)}
    tree = {"audio_embed": rnd(cfg.num_codebooks * cfg.vocab_size, D),
            "depth": {"layers": [layer() for _ in range(c.num_hidden_layers)],
                      "norm": torch.ones(d, device=dev), "proj": rnd(d, D)},
            "heads": rnd(cfg.num_codebooks - 1, d, cfg.vocab_size)}
    return CsmModel(tree, cfg)


def bound_ms(cfg: CsmConfig) -> float:
    """The cell's bound of a frame's depth passes: `cudabench.flops_csm`'s
    bytes (each pass's depth weights, projector, embedding row, head slice
    and cache read once) over HBM's rate, from `cfg` laid out as
    transformers' config.json (`CsmConfig.from_dict`'s input)."""
    c = dict(dataclasses.asdict(cfg.backbone), num_codebooks=cfg.num_codebooks,
             vocab_size=cfg.vocab_size, depth_decoder_config=dataclasses.asdict(cfg.depth))
    return 1e3 * flops_csm.depth_bytes(c) / flops.PEAK_BYTES


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
    model = depth_model(cfg, dev, args.seed)
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
    }
    line = json.dumps(result)
    print(line, flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
