#!/usr/bin/env python3
"""Chip smoke test of the torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises, so the script exits non-zero, on failure):
1. require a CUDA device; print the card's name and power limit;
2. build the kernels' sources from csrc/ with nvcc (sm_90a), one nvcc each,
   all started together, and print the build seconds and ptxas' register /
   shared-memory report; require Hopper's own tensor-core path in the SASS
   (`cuobjdump -sass`) of K2's kernel and K3's conv and fused residual-block
   kernels: warpgroup MMAs (HGMMA) and TMA tile loads (UTMALDG) in every
   instantiation, counts printed;
3. hold each of the five kernels against its plain PyTorch version at the
   main paths' shapes (full Sopro v1.5 and Mimi widths, random weights from
   a seed with the zero-initialised leaves filled, TF32 off) and time both
   with CUDA events; K4 at chunks of 6 and 16 AR frames (12 and 32 25 Hz
   rows; B = 1, B = 2 with partial histories, and B = 8 at chunk 16 as the
   serving tick runs it) and 802 rows, against
   float64 too and repeated bit-identically;
   K5 at B = 1 and 2, text buckets 64 and 2048, and 401 chained near-greedy
   steps of the K5 route token-identical to K1; µs per step of K5, of the
   plain step and of K1;
4. drive the synthesize path: `SoproTTS.from_random(device="cuda")`,
   `prepare_reference(ref_tokens_tq=...)`, three `synthesize` requests at
   max_frames=400 (launch counters zeroed just before, read just after),
   plus a repeat that must be identical; print seconds and real-time factor;
5. drive the stream path: three `SoproTTSStreamer.stream` requests at
   max_frames=400, chunk 6 (counters zeroed just before, read just after);
   every chunk but the last is 6 frames, the frames add up to
   `generate_tokens` at the same seed, samples are finite; print TTFA and
   the mean ms per steady chunk; a single-chunk stream (chunk 401) equals
   `synthesize` within 1e-4 of its peak;
6. reference from audio: a 10 s WAV written from a `synthesize` output,
   `encode_reference` / `prepare_reference(ref_audio_path=...)` on the card
   (codes [T, 32] in range), and a stream from that reference;
7. the batch path: `synthesize_batch` of 4 texts (one duplicated) at
   max_frames=400 (counters zeroed before, read after: K1, K2, K3 launched);
   each row equals its own `synthesize` within 1e-4 of its peak, the
   duplicated rows are identical; K3 at B = 4 against its plain version;
   `synthesize_long` of a paragraph of 4 chunks is as long as the chunks and
   the gaps; print seconds, RTF and seconds of audio per second;
8. the per-step route, `RuntimeConfig(use_pallas_resident=False)`: two
   400-frame `synthesize` requests, a B = 2 `synthesize_batch` and a chunk-6
   stream launch K5 and never K1; a B = 3 batch raises ValueError; a
   near-greedy request equals the K1 route within 1e-4 of its peak; print
   request seconds against the K1 route's.
9. checkpoint: `save_pretrained` of phase 4's model, a Mimi snapshot in
   `transformers.MimiModel` names written from the same seed's tree
   (`mimi_checkpoint_state_dict`, the inverse of the port's converter), both
   loaded again by `from_pretrained(..., on_unconsumed="raise")`: two
   400-frame `synthesize` requests equal phase 4's bit for bit; loaded
   again with `revision=`, `cache_dir=` and `token=` (bit for bit, K1-K3
   launched, no cache made) and, where `huggingface_hub` imports, by repo
   id from a hub cache written here, offline (HF_HUB_OFFLINE=1; the route
   taken is printed); where
   `transformers` imports, a WordLevel tokenizer in the snapshot goes through
   `from_pretrained`'s `TextTokenizer` (the route taken is printed);
   `from_pretrained(warmup=True)` launches K1-K4, and a request and a stream
   after it build nothing (the same kernel libraries, K1 weight streams, K2
   head stacks and SEANet pack) and equal phase 4's;
10. serve: `ContinuousBatcher` at 8 slots, text bucket 256, max_frames 400.
   Pass A (chunk 16, ramp 4, pcm16, after `warmup` and `reset_stats`): an
   8-way burst, then 4 sessions mid-flight (12 on 8 slots; counters zeroed
   before, read after: K1, K2, K4 launched, K3 and K5 not, one K1 launch per
   tick counted by `stats`); each session's first chunk is 4 frames and its
   inner chunks 16, its frame count that of `generate_tokens`; three
   sessions (one a mid-flight join) run again alone in a fresh batcher
   within 1 int16 LSB; tick and TTFA percentiles, each session's TTFA and
   steady chunk gap, seconds of audio per second. Pass B (ramp off, float):
   8 sessions each within 1e-4 of its peak of its solo `tts.stream`, their
   AR tokens equal to `generate_tokens`; on that state K1's µs per step and
   launch facts at B = 1, 4, 7, 8, 16 and 32 (one launch of one block per
   SM, in one wave: fails otherwise), each against the plain loop (rows at
   their own ages, per-row settings), and K2 on the tick's
   window gathered across 8 slots (8 x 197 rows, tail 8 x 16) against its
   plain version. HTTP: `server_stdlib` on 127.0.0.1 answers `/` and
   `/static/app.js` with the package's demo files (bytes equal), the
   reference cache, a SPRO stream (counters zeroed before, read after: K1,
   K2, K4 launched), a WAV and the stats with 200. Then 12 threads released
   by one barrier submit into one fresh batcher: one "sopro-batcher" thread
   at every look, every session as long as its `generate_tokens`.
11. train (`sopro_tpu_torch.train`, full width, random weights from a seed
   with the zero-initialised leaves filled; rows of S = 401 frames, row 0
   full so it has no EOS target, texts of 33-64 tokens, references of
   100-150 frames): one B = 2 step's loss and per-leaf gradients on the
   card against the CPU (TF32 off); 20 steps at B = 8 on one batch (the loss
   finite and falling, no kernel of K1-K5 launched; step ms by CUDA
   events, median after 3 warm steps;
   valid frames per second; peak memory; the step's FLOPs from
   `profiling.train_step_flops` and their share of the fp32 peak; a
   profiler trace of two more steps for the kernels' busy share, launches
   and synchronisations per step and the largest kernels; one more step split
   into forward, backward and optimizer). With deterministic algorithms on: the step through
   `parallel/data.py` at world size 1 on NCCL (`file://` rendezvous) equals the
   plain step; 2 steps, a train checkpoint, a restore into a fresh model
   and a third step equal 3 straight steps (the checkpoint also restores
   onto the CPU). The trained model's `synthesize` (its kernel caches built
   before the steps) equals, bit for bit, that of the model reloaded through
   `save_pretrained` / `from_pretrained`, and launches K1 and K2.
12. CLI: `python -m sopro_tpu_torch.cli --random_init --device cuda` in a
   subprocess: its WAV equals phase 4's `synthesize(..., pcm16=True)` at
   the same seed, `--metrics_json` prints the metrics, `--trace_dir`
   writes a Chrome trace that names K1, K2 and K3's kernels; `--stream`
   equals `stream` and `--long` equals `synthesize_long`.
13. bf16: `from_random(..., runtime=RuntimeConfig(compute_dtype="bfloat16"))`
   from phase 4's seed. Each bf16 kernel against its bf16 plain version
   (within 1e-2 of peak; K2's ids equal away from a 1e-4 top-2 margin; K1's
   tokens equal up to the first near-tie of the plain run) and timed beside
   it and the bf16 library call (K2 at 6, 187, 401 and 1,604 rows; K3 at
   B = 1 and 4; K4 at chunks 6 and 16 and at 8 rows with partial
   histories; K1 over 401 near-greedy steps and at 1, 4, 7, 8, 16 and 32
   rows (near-greedy rows against the plain loop); K5
   at B = 1 and 2); then, counters zeroed before and read after, three
   400-frame `synthesize` requests (K1, K2, K3 in bf16, no float32 kernel),
   three streams at chunk 6 (TTFA, steady chunk ms), a B = 4 batch, the
   per-step route (K5, not K1), an 8-way `ContinuousBatcher` burst (every
   session as long as its `generate_tokens`); the bf16 Mimi decode of the
   fp32 path's codes against the fp32 one (SNR, beside the JAX package's
   TPU claim of 41 dB; not gated).
14. mesh: the card count and each card's name and power limit; shards
   dp = 4 over 4 cards (2 over 2 or 3), else dp = 2 with both shards on
   cuda:0 (printed). A `ContinuousBatcher(mesh=)` and an unsharded one (8
   slots, chunk 16, ramp 4, pcm16, text bucket 256, max_frames 96) each
   take an 8-way burst with caps 96 x 4, 32, 48, 64, 80 and 4 joins
   mid-flight (counters zeroed before, read after: K1, K2, K4 launched, K3
   and K5 not; K1 launches = the ticks the shards ran); each session's
   frame count equal, PCM within 1 int16 LSB, AR tokens equal for the
   sessions still in their slot (a differing token only at a top-2 margin
   below 1e-5 of the peak logit); tick dispatch p50 per shard; burst TTFA
   p50; seconds of audio per second of both. `synthesize_batch(mesh=)` of
   phase 7's 4 texts at 400 frames (K1, K2, K3 launched): every row within
   1e-4 of its peak of the unsharded batch's row, lengths equal; seconds of
   audio per second of both, in turns.
15. tp training (`parallel/tensor.py`): phase 11's model and batch on
   (dp = 1, tp = 2) with both shards on cuda:0 (a rehearsal), tp = 2 over 2
   cards and (dp = 2, tp = 2) over 4 where present: the loss within 2e-5
   relative and each leaf's gathered gradient within 1e-4 of its peak
   (plus 1e-6 of the largest) of the unsharded step's; after 2 steps of
   each the parameters within the TP_PARAM tolerances; the sharded state
   saved and restored onto an unsharded model bit for bit, and a third step
   of both within the same tolerances; no kernel of K1-K5 launched; step
   ms (CUDA events), host ms, valid frames/s and peak memory per card
   beside the unsharded step timed in the same turn and phase 11's.
The last three lines are the card's name and power limit, the kernels' JSON
record and {"ok": true, "device": {...}}. Per kernel the record holds its
launches in its path's counted run and per request of that run (K1, K2 and
K4 also in the serve run, per session), its time,
its plain version's, the library's (K2: einsum + argmax; K3 and K4: the
stack as cuDNN convs, `bench_kernels.seanet_library`; K1 and K5: none), and
its bound (`bench_kernels.bound`: bytes over HBM's rate, or operations over
the 3-pass TF32 rate for the tensor-core kernels K2, K3 and K4 and the fp32
rate for K1 and K5); K2 also at 6, 187, 401 and 1,604 rows and at the
serve tick's window, K1 also at 1, 4, 7, 8, 16 and 32 serving rows (with
its launch facts), K3 also at
B = 4, K4 also at chunk 16, with errors against float64 plain versions.
Each record's "bf16" entry holds the same keys for the kernel's bfloat16
instantiation (launches from the bf16 path it belongs to; bounds at 2
bytes an element and the bf16 tensor-core rate).
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
MAX_FRAMES = 400
REQUESTS = (
    ("The quick brown fox jumps over the lazy dog.", 1),
    ("Sopro speaks again, this time on a graphics card.", 2),
    ("A third request, with a different seed and a different length of text.", 3),
)
KERNELS = {
    "ar_loop": ("sopro_tpu_torch/csrc/ar_loop.cu", "sopro_tpu/ops/pallas_ar_loop.py:363"),
    "ar_step": ("sopro_tpu_torch/csrc/ar_loop.cu", "sopro_tpu/ops/pallas_ar.py:305"),
    "nar_heads": ("sopro_tpu_torch/csrc/nar_heads.cu", "sopro_tpu/ops/pallas_nar.py:53"),
    "seanet": ("sopro_tpu_torch/csrc/seanet.cu", "sopro_tpu/codec/pallas_vocoder.py:353"),
    "seanet_chunk": ("sopro_tpu_torch/csrc/seanet.cu", "sopro_tpu/codec/pallas_vocoder.py:383"),
}
CHUNK = 6  # stream() default chunk, AR frames
# K4 as the serving tick runs it: 8 rows, chunk 16 (32 rows at 25 Hz), rows at different ages
SERVE_K4 = (8, 32, (0, 2, 4, 6, 8, 8, 8, 8))
# K2's row counts per stage: stream stage E, a stream window, one request, a B = 4 batch
NAR_ROWS = (6, 187, MAX_FRAMES + 1, 4 * (MAX_FRAMES + 1))
STREAM_REQUESTS = (
    ("Streaming from a graphics card, one small chunk at a time.", 4),
    ("A second streamed request.", 5),
    ("A third streamed request, with a longer text than the second one had.", 6),
)
# four texts of 33-64 characters (one text bucket), the first one twice
BATCH = ((REQUESTS[0][0], REQUESTS[1][0], STREAM_REQUESTS[0][0], REQUESTS[0][0]), (1, 2, 4, 1))
LONG_MAX_CHARS = 80  # PARAGRAPH splits into 4 chunks
PER_STEP_REQUESTS = 4  # the per-step route's counted run: 2 synthesize, 1 batch, 1 stream
PARAGRAPH = (
    "Long-form speech is split into sentences. Each sentence is its own row of one batch. "
    "The rows decode side by side on the card, each with its own seed. "
    "Then the pieces are joined with a short silence between them."
)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of `fn` on the device (CUDA events, one warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def gpu_lines() -> list:
    """`nvidia-smi --query-gpu=name,power.limit`, a line per card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()


def gpu_line() -> str:
    return gpu_lines()[0]


# kernels on Hopper's own path: (source, function name part)
HOPPER_KERNELS = (("nar_heads", "nar_heads_kernel"), ("seanet", "conv_wgmma_kernel"),
                  ("seanet", "resblock_wgmma_kernel"))


def check_hopper_sass():
    """Every instantiation of K2's kernel and of K3's conv and fused
    residual-block kernels holds HGMMA (wgmma) and UTMALDG (TMA tile load)
    instructions in its SASS."""
    from sopro_tpu_torch import kernels

    for source, kernel in HOPPER_KERNELS:
        counts = kernels.sass_counts(source, kernel, ("HGMMA", "UTMALDG"))
        if not counts:
            raise AssertionError(f"{source}: no function named *{kernel}* in its SASS")
        for fn, c in counts.items():
            log(f"  {source} SASS {fn}: HGMMA {c['HGMMA']}, UTMALDG {c['UTMALDG']}")
            if not (c["HGMMA"] and c["UTMALDG"]):
                raise AssertionError(f"{source} {fn}: no HGMMA or no UTMALDG in its SASS")


def build_models(dev, seed: int, cfg, mcfg):
    """Sopro and Mimi on `dev` with the zero-inits filled."""
    from sopro_tpu_torch import weights as W

    tree = W.init_sopro_params(seed, cfg, 259)
    mtree = W.init_mimi_params(seed, mcfg)
    W.fill_zero_inits(tree, mtree, seed + 1)
    return W.sopro_params_from_jax(tree, cfg, dev), W.mimi_params_from_jax(mtree, mcfg, dev)


def check_nar_heads(model, dev, rng):
    """K2 over the four stages at each of NAR_ROWS rows (stream stage E,
    stream window, one request, a B = 4 batch): ids equal to the plain
    version's wherever the top-2 margin is above 1e-5; the error is the
    largest gap between the float64 logit of the chosen id and the float64
    maximum. The plain version (einsum + argmax) is also the library call."""
    from sopro_tpu_torch.bench_kernels import bound, nar_cost
    from sopro_tpu_torch.ops.nar_heads import nar_heads_argmax, nar_heads_argmax_plain

    out = {"max_abs_err": 0.0, "mismatches": 0}
    for rows in NAR_ROWS:
        ms = plain_ms = flop = nbytes = 0.0
        for stage, (hid, w, b, packed) in model.nar.head_stacks().items():
            z = torch.from_numpy(rng.standard_normal((1, rows, w.shape[1])).astype(np.float32)).to(dev)
            got = nar_heads_argmax(z, hid, w, b, packed)
            want = nar_heads_argmax_plain(z, hid, w, b)
            logits = torch.einsum("bthd,hdv->bthv", (z[:, :, None, :] + hid[None, None]).double(),
                                  w.double()) + b[None, None].double()
            top2 = torch.topk(logits, 2, dim=-1).values
            differ = got != want
            bad = int((differ & (top2[..., 0] - top2[..., 1] > 1e-5)).sum())
            if bad:
                raise AssertionError(f"nar_heads {rows} rows stage {stage}: {bad} ids differ at a "
                                     f"clear margin")
            out["mismatches"] += int(differ.sum())
            gl = torch.gather(logits, -1, got.long()[..., None])[..., 0]
            out["max_abs_err"] = max(out["max_abs_err"], float((top2[..., 0] - gl).max()))
            ms += cuda_ms(lambda: nar_heads_argmax(z, hid, w, b, packed), 20)
            plain_ms += cuda_ms(lambda: nar_heads_argmax_plain(z, hid, w, b), 20)
            f, n = nar_cost(rows, *w.shape)
            flop, nbytes = flop + f, nbytes + n
            if differ.any():
                log(f"  nar_heads {rows} rows stage {stage}: ids differ at {int(differ.sum())} "
                    f"near-tie positions of {differ.numel()}")
        bnd = bound(flop, nbytes, tf32x3=True)
        log(f"  nar_heads {rows} rows, 4 stages: {ms:.3f} ms (kernel) vs {plain_ms:.3f} ms "
            f"(plain = einsum + argmax); bound {bnd['bound_ms']:.4f} ms ({bnd['bound_rate']}), "
            f"fp32 bound {bnd['fp32_bound_ms']:.4f} ms")
        out[rows] = dict(ms=ms, plain_ms=plain_ms, library_ms=plain_ms, **bnd)
    log(f"  nar_heads: ids differ only at near-ties ({out['mismatches']} positions); worst float64 "
        f"logit gap of a chosen id {out['max_abs_err']:.3e}")
    return dict(out[MAX_FRAMES + 1], max_abs_err=out["max_abs_err"],
                by_rows={r: out[r] for r in NAR_ROWS})


def float64_decoder(mimi):
    from sopro_tpu_torch.models.base import tree_map

    return tree_map(lambda a: a.double() if torch.is_floating_point(a) else a, mimi.p["decoder"])


def check_seanet(mimi, dev, rng, b=1):
    """K3 on the Mimi decoder's own embeddings of 401 random 25 Hz frames:
    within 1e-4 of peak of the float32 plain version; its error against a
    float64 plain version, and the float32 plain version's own; timed beside
    the plain version and the library stack (cuDNN convs, TF32 off)."""
    from sopro_tpu_torch.bench_kernels import (
        bound, conv_stack_cost, seanet_library, seanet_library_weights,
    )
    from sopro_tpu_torch.codec.mimi import decode_embeddings, seanet_apply
    from sopro_tpu_torch.codec.mimi_config import decoder_plan
    from sopro_tpu_torch.codec.vocoder import seanet_decode

    cfg, plan = mimi.cfg, decoder_plan(mimi.cfg)
    codes = torch.from_numpy(
        rng.integers(0, cfg.codebook_size, (b, MAX_FRAMES + 1, cfg.num_quantizers))
    ).to(dev)
    with torch.inference_mode():
        emb = decode_embeddings(mimi.p, cfg, codes).contiguous()
        packed = mimi.packed_decoder()
        got = seanet_decode(packed, cfg, emb)
        want = seanet_apply(mimi.p["decoder"], plan, emb)[..., 0]
        ref = seanet_apply(float64_decoder(mimi), plan, emb.double())[..., 0]
        lib_w = seanet_library_weights(mimi.p["decoder"], plan)
        lib = seanet_library(lib_w, emb)
        torch.cuda.synchronize()
        if tuple(got.shape) != (b, emb.shape[1] * int(np.prod(cfg.upsampling_ratios))):
            raise AssertionError(f"seanet: shape {tuple(got.shape)}")
        err, peak = float((got - want).abs().max()), float(want.abs().max())
        err64 = float((got.double() - ref).abs().max())
        plain64 = float((want.double() - ref).abs().max())
        log(f"  seanet: emb {tuple(emb.shape)} -> wav {tuple(got.shape)}, max|err| {err:.3e} "
            f"(float64: kernel {err64:.3e}, float32 plain {plain64:.3e}, library "
            f"{float((lib.double() - ref).abs().max()):.3e}), max|wav| {peak:.3e}")
        if not err <= 1e-4 * peak:
            raise AssertionError(f"seanet: max|err| {err} > 1e-4 * max|wav| {peak}")
        if not float((lib - want).abs().max()) <= 1e-4 * peak:
            raise AssertionError("seanet: the library stack disagrees with the plain version")
        ms = cuda_ms(lambda: seanet_decode(packed, cfg, emb), 5)
        plain_ms = cuda_ms(lambda: seanet_apply(mimi.p["decoder"], plan, emb), 5)
        library_ms = cuda_ms(lambda: seanet_library(lib_w, emb), 5)
    bnd = bound(*conv_stack_cost(packed["ops"], b, emb.shape[1], causal=True), tf32x3=True)
    log(f"  seanet B={b}: {ms:.3f} ms (kernel) vs {plain_ms:.3f} ms (plain), {library_ms:.3f} ms "
        f"(cuDNN stack); bound {bnd['bound_ms']:.4f} ms ({bnd['bound_rate']}), fp32 bound "
        f"{bnd['fp32_bound_ms']:.4f} ms")
    return dict(max_abs_err=err, err_f64=err64, plain_err_f64=plain64, peak=peak, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, **bnd)


def check_seanet_chunk(mimi, dev, rng):
    """K4 against its plain version on [halo frames ++ chunk] taken from the
    Mimi decoder's own embeddings, at chunks of 6 and 16 AR frames (12 and 32
    25 Hz rows), B = 1 with a full history and B = 2 with rows a few frames
    into their streams, and over a whole utterance (802 rows): within 1e-4
    of peak of the float32 plain version, its error against a float64 plain
    version reported, and a repeated call bit-identical (the split-K
    partials meet in a fixed order); timed at each shape."""
    from sopro_tpu_torch.bench_kernels import (
        bound, conv_stack_cost, seanet_library, seanet_library_weights,
    )
    from sopro_tpu_torch.codec.mimi import decode_embeddings
    from sopro_tpu_torch.codec.mimi_config import decoder_plan, required_halo
    from sopro_tpu_torch.codec.vocoder import seanet_decode_chunk, seanet_decode_chunk_plain

    cfg = mimi.cfg
    halo, hop25 = required_halo(cfg), int(np.prod(cfg.upsampling_ratios))
    packed, params = mimi.packed_decoder(), mimi.p["decoder"]
    lib_w = seanet_library_weights(params, decoder_plan(cfg))
    out = {}
    with torch.inference_mode():
        for b, m25, hist in ((1, 2 * CHUNK, None), (2, 2 * CHUNK, (0, 5)), (1, 32, None),
                             (2, 32, (3, halo)), SERVE_K4, (1, 2 * (MAX_FRAMES + 1), None)):
            frames = -(-(halo + m25) // 2)  # 12.5 Hz frames -> 2 embedding rows each
            codes = torch.from_numpy(
                rng.integers(0, cfg.codebook_size, (b, frames, cfg.num_quantizers))
            ).to(dev)
            ext = decode_embeddings(mimi.p, cfg, codes)[:, -(halo + m25):].contiguous()
            n_hist = None if hist is None else torch.tensor(hist, dtype=torch.int32, device=dev)
            got = seanet_decode_chunk(packed, cfg, ext, n_hist)
            again = seanet_decode_chunk(packed, cfg, ext, n_hist)
            want = seanet_decode_chunk_plain(params, cfg, ext, n_hist)
            ref = seanet_decode_chunk_plain(float64_decoder(mimi), cfg, ext.double(), n_hist)
            torch.cuda.synchronize()
            what = f"seanet_chunk B={b} ext {tuple(ext.shape)} n_hist={hist or halo}"
            if tuple(got.shape) != (b, m25 * hop25):
                raise AssertionError(f"{what}: shape {tuple(got.shape)}")
            if not torch.equal(got, again):
                raise AssertionError(f"{what}: a repeated call is not bit-identical")
            err, peak = float((got - want).abs().max()), float(want.abs().max())
            if not err <= 1e-4 * peak:
                raise AssertionError(f"{what}: max|err| {err} > 1e-4 * max|wav| {peak}")
            ms = cuda_ms(lambda: seanet_decode_chunk(packed, cfg, ext, n_hist), 20)
            plain_ms = cuda_ms(lambda: seanet_decode_chunk_plain(params, cfg, ext, n_hist), 20)
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "err_f64": float((got.double() - ref).abs().max()),
                   "plain_err_f64": float((want.double() - ref).abs().max())}
            extra = ""
            if hist is None:  # the library stack decodes all of ext causally: the same samples
                n_out = m25 * hop25
                lib = seanet_library(lib_w, ext)[:, -n_out:]
                if not float((lib - want).abs().max()) <= 1e-4 * peak:
                    raise AssertionError(f"{what}: the library stack disagrees with the plain version")
                row["library_ms"] = cuda_ms(lambda: seanet_library(lib_w, ext)[:, -n_out:], 20)
                row.update(bound(*conv_stack_cost(packed["ops"], b, ext.shape[1], causal=False,
                                                  keep=m25 * hop25), tf32x3=True))
                extra = (f"; library {row['library_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
                         f"({row['bound_rate']}), fp32 bound {row['fp32_bound_ms']:.4f} ms")
            log(f"  {what} -> wav {tuple(got.shape)}: max|err| {err:.3e} (float64: kernel "
                f"{row['err_f64']:.3e}, float32 plain {row['plain_err_f64']:.3e}), max|wav| "
                f"{peak:.3e}, repeat bit-identical; {ms:.3f} ms (kernel) vs {plain_ms:.3f} ms "
                f"(plain){extra}")
            out[(b, m25, hist)] = row
    worst = max(v["max_abs_err"] for v in out.values())
    return dict(out[(1, 2 * CHUNK, None)], max_abs_err=worst, chunk16=out[(1, 32, None)],
                serve_b8=out[SERVE_K4], err_f64_worst=max(v["err_f64"] for v in out.values()))


def check_ar_loop(model, mimi, dev, rng):
    from sopro_tpu_torch.engine import Engine
    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.ops.ar_loop import ar_loop, ar_loop_plain
    from sopro_tpu_torch.tokenizer import SimpleCharTokenizer

    eng = Engine(model, mimi)
    cfg = model.cfg
    ref = eng.prepare_reference(
        rng.integers(0, cfg.codebook_size, (150, cfg.num_codebooks)).astype(np.int32)
    )
    ids = np.asarray(SimpleCharTokenizer().encode(REQUESTS[0][0]), np.int32)
    s = MAX_FRAMES + 1
    with torch.inference_mode():
        prep = eng.prepare_conditioning(ids, ref, max_frames=MAX_FRAMES, style_strength=1.0)
        cond = prep["cond_ar"]
        ctx = M.ar_context(model, prep["txt_seq"], prep["text_mask"])

        def fresh():
            c = M.init_ar_carry(model.cfg, 1, s, 7, dev)
            return {k: getattr(c, k) for k in ("t", "last", "streak", "stopped",
                                               "first_eos", "key", "hist", "bufs")}

        out = {}
        for name, sett in (
            ("near-greedy", M.ARSettings(temperature=1e-4, anti_loop=False)),
            ("production", M.ARSettings()),
        ):
            per_row = sett.per_row(1, dev)
            tk, sk = ar_loop(ctx, cond, fresh(), per_row, s, sett.anti_loop)
            tk2, _ = ar_loop(ctx, cond, fresh(), per_row, s, sett.anti_loop)
            tp, sp = ar_loop_plain(ctx, cond, fresh(), per_row, s, sett.anti_loop)
            torch.cuda.synchronize()
            if not torch.equal(tk, tk2):
                raise AssertionError(f"ar_loop {name}: two kernel runs differ")
            n_k, n_p = int(sk["t"][0]), int(sp["t"][0])
            diff = (tk[0] != tp[0]).nonzero()
            first = int(diff[0]) if len(diff) else -1
            log(f"  ar_loop {name}: kernel t={n_k} plain t={n_p}, first differing frame {first}")
            if name == "near-greedy":
                if first >= 0 or n_k != n_p:
                    raise AssertionError("ar_loop near-greedy: kernel tokens differ from plain")
                for k in ("last", "streak", "stopped", "first_eos", "key", "hist"):
                    if not torch.equal(sk[k], sp[k]):
                        raise AssertionError(f"ar_loop near-greedy: state {k} differs")
                out["max_abs_err"] = float((sk["bufs"] - sp["bufs"]).abs().max())
                log(f"  ar_loop near-greedy: conv-state max|err| {out['max_abs_err']:.3e}")
            out[f"first_diff_{name}"] = first
        sett = M.ARSettings()
        per_row = sett.per_row(1, dev)
        out["ms"] = cuda_ms(lambda: ar_loop(ctx, cond, fresh(), per_row, s, True), 3)
        out["plain_ms"] = cuda_ms(lambda: ar_loop_plain(ctx, cond, fresh(), per_row, s, True), 1)
        _, st = ar_loop(ctx, cond, fresh(), per_row, s, True)
        out["steps"] = int(st["t"][0])
        out["us_per_step"] = out["ms"] * 1e3 / out["steps"]
    from sopro_tpu_torch import kernels
    from sopro_tpu_torch.bench_kernels import ar_cost, bound

    kv_k = torch.stack([c["k"] for c in ctx.kv if c is not None])
    out.update(bound(*ar_cost(ctx.stacked, kv_k, out["steps"], 1), tf32x3=False), library_ms=None)
    log(f"  ar_loop: {out['steps']} steps {out['ms']:.3f} ms (kernel) vs "
        f"{out['plain_ms']:.3f} ms (plain); bound {out['bound_ms']:.4f} ms ({out['bound_rate']}); "
        f"launch {kernels.LAUNCH_INFO.get('ar_loop')}")
    return out


LONG_TEXT = " ".join(f"Sentence number {i} of a long prompt that fills the largest text bucket."
                     for i in range(20))  # 1,450 characters: text bucket 2048


def check_ar_step(model, mimi, dev, rng, k1):
    """K5 against its plain version at full width (B = 1 and 2, text bucket
    64 and 2048, real conditioning, row 0 partly masked and row 1 holding
    only 9 text tokens); 401 chained near-greedy steps of the K5 route
    against the K1 route; µs per step of K5, the plain step and K1."""
    from sopro_tpu_torch.engine import Engine
    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.models.generator import conv_ctx
    from sopro_tpu_torch.ops.ar_step import ar_step, ar_step_plain
    from sopro_tpu_torch.tokenizer import SimpleCharTokenizer

    eng, cfg, tok = Engine(model, mimi), model.cfg, SimpleCharTokenizer()
    ref = eng.prepare_reference(
        rng.integers(0, cfg.codebook_size, (150, cfg.num_codebooks)).astype(np.int32)
    )
    s = MAX_FRAMES + 1
    worst, out = 0.0, {}
    with torch.inference_mode():
        for text in (REQUESTS[0][0], LONG_TEXT):
            for b in (1, 2):
                rows = [np.asarray(tok.encode(t), np.int32) for t in (text, "Short one")[:b]]
                ids, mask = eng._padded(rows, eng.rt.text_buckets)
                prep = M.prepare_conditioning(model, ids, mask, M.tile_reference(ref, b),
                                              max_frames=MAX_FRAMES, style_strength=1.0)
                ctx = M.ar_step_context(model, prep["txt_seq"], mask)
                x = (prep["cond_ar"][:, 0] + ctx.emb[-1]).contiguous()
                bufs = torch.from_numpy(rng.standard_normal(
                    (cfg.n_layers_ar, b, conv_ctx(cfg), cfg.d_model)
                ).astype(np.float32) * 0.3).to(dev)
                got, want = ar_step(ctx, x, bufs), ar_step_plain(ctx, x, bufs)
                torch.cuda.synchronize()
                what = f"ar_step B={b} L={mask.shape[1]}"
                for name, g, w in (("logits", got[0], want[0]), ("bufs", got[1], want[1])):
                    err, peak = float((g - w).abs().max()), float(w.abs().max())
                    log(f"  {what} {name} {tuple(g.shape)}: max|err| {err:.3e}, peak {peak:.3e}")
                    if tuple(g.shape) != tuple(w.shape) or not err <= 1e-5 * peak:
                        raise AssertionError(f"{what}: {name} max|err| {err} > 1e-5 * peak {peak}")
                    worst = max(worst, err) if name == "logits" else worst
                if (text, b) == (REQUESTS[0][0], 1):
                    out["ms"] = cuda_ms(lambda: ar_step(ctx, x, bufs), 50)
                    out["plain_ms"] = cuda_ms(lambda: ar_step_plain(ctx, x, bufs), 20)
                    cond, step_ctx = prep["cond_ar"], ctx
                    loop_ctx = M.ar_context(model, prep["txt_seq"], mask)
        sett = M.ARSettings(temperature=1e-4, anti_loop=False)
        carry = M.init_ar_carry(cfg, 1, s, 7, dev)
        k5 = M.ar_chunk(carry, cond, step_ctx, sett, s)
        k1_run = M.ar_chunk(carry, cond, loop_ctx, sett, s)
        torch.cuda.synchronize()
        same = torch.equal(k5.tokens, k1_run.tokens) and torch.equal(k5.t, k1_run.t) \
            and torch.equal(k5.first_eos, k1_run.first_eos)
        log(f"  ar_step route, {int(k5.t[0])} near-greedy steps: tokens "
            f"{'identical to' if same else 'DIFFER from'} the K1 route ({int(k1_run.t[0])} steps)")
        if not same:
            raise AssertionError("ar_step near-greedy: tokens differ from K1")
    from sopro_tpu_torch.bench_kernels import ar_cost, bound

    out.update(bound(*ar_cost(step_ctx.stacked, step_ctx.kv_k, 1, 1), tf32x3=False),
               max_abs_err=worst, library_ms=None)
    log(f"  K5 bound (B = 1, L = 64): {out['bound_ms'] * 1e3:.2f} µs ({out['bound_rate']})")
    log(f"  per step (B = 1, L = 64): K5 {out['ms'] * 1e3:.1f} µs, plain step "
        f"{out['plain_ms'] * 1e3:.1f} µs, K1 {k1['ms'] / k1['steps'] * 1e3:.1f} µs "
        f"({k1['ms']:.3f} ms / {k1['steps']} steps)")
    return out


def launched(path: str, needed):
    """The launch counts since the last reset; raises unless every kernel in
    `needed` launched."""
    from sopro_tpu_torch import kernels

    launches = dict(kernels.LAUNCHES)
    log(f"  launches during the {path} run: {launches}")
    missing = [k for k in needed if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the {path} path did not launch: {missing}")
    return launches


def drive_main_path(dev, rng, cfg, mcfg):
    from sopro_tpu_torch import kernels
    from sopro_tpu_torch.tts import SoproTTS

    t0 = time.perf_counter()
    tts = SoproTTS.from_random(cfg, seed=SEED, mimi_cfg=mcfg, device=dev)
    log(f"  from_random: {time.perf_counter() - t0:.2f} s")
    ref_tokens = rng.integers(0, cfg.codebook_size, (150, cfg.num_codebooks)).astype(np.int32)
    ref = tts.prepare_reference(ref_tokens_tq=ref_tokens)
    hop = tts.engine.mimi_cfg.hop_length
    tts.synthesize("warm up", ref=ref, max_frames=8, seed=0)  # first-call costs outside the run
    torch.cuda.synchronize()

    kernels.reset_launches()
    results = []
    for text, seed in REQUESTS:
        t1 = time.perf_counter()
        wav = tts.synthesize(text, ref=ref, max_frames=MAX_FRAMES, seed=seed)
        sec = time.perf_counter() - t1
        frames = wav.shape[1] // hop
        if wav.ndim != 2 or wav.shape[0] != 1 or frames <= 0 or wav.shape[1] != frames * hop:
            raise AssertionError(f"synthesize: bad waveform shape {wav.shape}")
        if not np.isfinite(wav).all():
            raise AssertionError("synthesize: non-finite samples")
        audio_s = wav.shape[1] / float(mcfg.sampling_rate)
        results.append((text, seed, frames, sec, sec / audio_s))
        log(f"  request seed={seed}: {frames} frames, {audio_s:.2f} s audio in {sec:.3f} s, "
            f"RTF {sec / audio_s:.4f}")
    launches = launched("synthesize", ("ar_loop", "nar_heads", "seanet"))
    text, seed = REQUESTS[0]
    again = tts.synthesize(text, ref=ref, max_frames=MAX_FRAMES, seed=seed)
    first = tts.synthesize(text, ref=ref, max_frames=MAX_FRAMES, seed=seed)
    if not np.array_equal(again, first):
        raise AssertionError("synthesize: a repeated request gave a different waveform")
    return launches, tts, ref, ref_tokens


def close_to(got, want, what, tol=1e-4):
    """Raise unless `got` has `want`'s shape and lies within tol * peak."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} vs {want.shape}")
    err, peak = float(np.abs(got - want).max(initial=0.0)), float(np.abs(want).max(initial=0.0))
    if not err <= tol * peak:
        raise AssertionError(f"{what}: max|err| {err} > {tol} * peak {peak}")
    return err, peak


def drive_batch_path(tts, ref, dev, rng):
    """synthesize_batch of BATCH (counted), each row against its own
    synthesize, K3 at B = 4, and synthesize_long of PARAGRAPH."""
    from sopro_tpu_torch import kernels
    from sopro_tpu_torch.tts import split_sentences

    texts, seeds = BATCH
    sr, hop = tts.engine.mimi_cfg.sampling_rate, tts.engine.mimi_cfg.hop_length
    tts.synthesize_batch(texts, ref=ref, max_frames=8, seeds=seeds)  # first-call costs outside
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    outs = tts.synthesize_batch(texts, ref=ref, max_frames=MAX_FRAMES, seeds=seeds)
    sec = time.perf_counter() - t0
    launches = launched("batch", ("ar_loop", "nar_heads", "seanet"))
    audio_s = sum(o.shape[1] for o in outs) / float(sr)
    log(f"  synthesize_batch B={len(texts)}: {[o.shape[1] // hop for o in outs]} frames, "
        f"{audio_s:.2f} s audio in {sec:.3f} s, RTF {sec / audio_s:.4f}, "
        f"{audio_s / sec:.1f} s of audio per second")
    if not all(np.isfinite(o).all() for o in outs):
        raise AssertionError("synthesize_batch: non-finite samples")
    if not np.array_equal(outs[0], outs[3]):
        raise AssertionError("synthesize_batch: duplicated rows differ")
    singles = 0.0
    for i, (text, seed) in enumerate(zip(texts, seeds)):
        t1 = time.perf_counter()
        one = tts.synthesize(text, ref=ref, max_frames=MAX_FRAMES, seed=seed)
        singles += time.perf_counter() - t1
        err, peak = close_to(outs[i], one, f"synthesize_batch row {i}")
        log(f"  row {i} vs synthesize(seed={seed}): max|err| {err:.3e}, peak {peak:.3e}")
    log(f"  the same four requests one by one: {singles:.3f} s")
    seanet_b4 = check_seanet(tts.engine.mimi, dev, rng, b=len(texts))

    chunks = split_sentences(PARAGRAPH, max_chars=LONG_MAX_CHARS)
    if len(chunks) < 3:
        raise AssertionError(f"synthesize_long: {len(chunks)} chunks")
    t0 = time.perf_counter()
    long = tts.synthesize_long(PARAGRAPH, ref=ref, max_frames=MAX_FRAMES, seed=9,
                               max_chars=LONG_MAX_CHARS)
    sec = time.perf_counter() - t0
    rows = tts.synthesize_batch(chunks, ref=ref, max_frames=MAX_FRAMES,
                                seeds=[9 + i for i in range(len(chunks))])
    gap = int(round(120.0 / 1000.0 * sr))
    want = sum(r.shape[1] for r in rows) + gap * (len(chunks) - 1)
    if long.shape != (1, want) or not np.isfinite(long).all():
        raise AssertionError(f"synthesize_long: {long.shape}, want (1, {want})")
    log(f"  synthesize_long: {len(chunks)} chunks, {long.shape[1] / sr:.2f} s audio in "
        f"{sec:.3f} s, = the chunks plus {len(chunks) - 1} gaps")
    return launches, seanet_b4


def drive_per_step_route(cfg, mcfg, dev, ref_tokens, k1_tts, k1_ref):
    """The K5 route: a SoproTTS with use_pallas_resident=False (same seed,
    same weights as `k1_tts`); counted requests, then the B = 3 refusal and
    a near-greedy request against the K1 route."""
    from sopro_tpu_torch import kernels
    from sopro_tpu_torch.config import RuntimeConfig
    from sopro_tpu_torch.tts import SoproTTS

    tts = SoproTTS.from_random(cfg, seed=SEED, mimi_cfg=mcfg, device=dev,
                               runtime=RuntimeConfig(use_pallas_resident=False))
    ref = tts.prepare_reference(ref_tokens_tq=ref_tokens)
    tts.synthesize("warm up", ref=ref, max_frames=8, seed=0)  # first-call costs outside the run
    torch.cuda.synchronize()
    kernels.reset_launches()
    secs = []
    for text, seed in REQUESTS[:2]:
        t0 = time.perf_counter()
        wav = tts.synthesize(text, ref=ref, max_frames=MAX_FRAMES, seed=seed)
        secs.append(time.perf_counter() - t0)
        if wav.shape[1] <= 0 or not np.isfinite(wav).all():
            raise AssertionError(f"per-step synthesize: {wav.shape}")
    texts, seeds = BATCH[0][:2], BATCH[1][:2]
    t0 = time.perf_counter()
    outs = tts.synthesize_batch(texts, ref=ref, max_frames=MAX_FRAMES, seeds=seeds)
    batch_s = time.perf_counter() - t0
    text, seed = STREAM_REQUESTS[0]
    chunks, ttfa, gaps = run_stream(tts, text, ref, seed)
    launches = launched("per-step route", ("ar_step", "nar_heads", "seanet", "seanet_chunk"))
    if launches["ar_loop"]:
        raise AssertionError(f"per-step route launched K1 {launches['ar_loop']} times")
    frames = check_stream(chunks, tts, text, ref, seed, "per-step stream")
    try:
        tts.synthesize_batch(BATCH[0][:3], ref=ref, max_frames=8)
    except ValueError as e:
        log(f"  B=3 on the per-step route raises ValueError: {e}")
    else:
        raise AssertionError("per-step route: a B = 3 batch did not raise")

    k1_secs = []
    for text, seed in REQUESTS[:2]:
        t0 = time.perf_counter()
        k1_tts.synthesize(text, ref=k1_ref, max_frames=MAX_FRAMES, seed=seed)
        k1_secs.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    k1_tts.synthesize_batch(texts, ref=k1_ref, max_frames=MAX_FRAMES, seeds=seeds)
    k1_batch_s = time.perf_counter() - t0
    log(f"  synthesize, {MAX_FRAMES + 1} frames: {', '.join(f'{x:.3f}' for x in secs)} s (K5 route) vs "
        f"{', '.join(f'{x:.3f}' for x in k1_secs)} s (K1 route)")
    log(f"  synthesize_batch B=2: {batch_s:.3f} s (K5 route, {[o.shape[1] for o in outs]} samples) "
        f"vs {k1_batch_s:.3f} s (K1 route)")
    log(f"  stream chunk {CHUNK}: {frames} frames, TTFA {ttfa * 1e3:.2f} ms, steady chunk mean "
        f"{statistics.mean(gaps) * 1e3:.2f} ms (K5 route)")
    text, seed = REQUESTS[2]
    greedy = dict(max_frames=MAX_FRAMES, seed=seed, temperature=1e-4, anti_loop=False)
    err, peak = close_to(tts.synthesize(text, ref=ref, **greedy),
                         k1_tts.synthesize(text, ref=k1_ref, **greedy), "per-step near-greedy")
    log(f"  near-greedy request, K5 route vs K1 route: max|err| {err:.3e}, peak {peak:.3e}")
    return launches


def run_stream(tts, text, ref, seed, chunk=CHUNK):
    """One streamed request -> (chunks, ttfa s, host seconds between chunks)."""
    from sopro_tpu_torch.streaming import SoproTTSStreamer, StreamConfig

    streamer = SoproTTSStreamer(tts, StreamConfig(chunk_frames=chunk))
    chunks, gaps = [], []
    t = time.perf_counter()
    for c in streamer.stream(text, ref=ref, max_frames=MAX_FRAMES, chunk_frames=chunk, seed=seed):
        now = time.perf_counter()
        chunks.append(c)
        gaps.append(now - t)
        t = now
    return chunks, streamer.last_ttfa_s, gaps[1:]


def check_stream(chunks, tts, text, ref, seed, what):
    """Every chunk but the last is CHUNK frames, all finite, and the frames
    add up to generate_tokens' at the same seed. Returns the frame count."""
    hop = tts.engine.mimi_cfg.hop_length
    for c in chunks[:-1]:
        if c.shape != (1, CHUNK * hop) or c.dtype != np.float32:
            raise AssertionError(f"{what}: chunk {c.shape} {c.dtype}, want (1, {CHUNK * hop})")
    for c in chunks[-1:]:
        if c.shape[0] != 1 or not 0 < c.shape[1] <= CHUNK * hop or c.shape[1] % hop:
            raise AssertionError(f"{what}: last chunk {c.shape}")
    if not all(np.isfinite(c).all() for c in chunks):
        raise AssertionError(f"{what}: non-finite samples")
    frames = sum(c.shape[1] for c in chunks) // hop
    want = tts.generate_tokens(text, ref, max_frames=MAX_FRAMES, seed=seed).shape[0]
    if frames != want:
        raise AssertionError(f"{what}: {frames} frames streamed, generate_tokens gives {want}")
    return frames


def drive_stream_path(tts, ref):
    from sopro_tpu_torch import kernels

    run_stream(tts, "warm up", ref, 0)  # first-call costs outside the run
    torch.cuda.synchronize()
    kernels.reset_launches()
    runs = [(text, seed, *run_stream(tts, text, ref, seed)) for text, seed in STREAM_REQUESTS]
    launches = launched("stream", ("ar_loop", "nar_heads", "seanet_chunk"))
    for text, seed, chunks, ttfa, gaps in runs:
        frames = check_stream(chunks, tts, text, ref, seed, f"stream seed={seed}")
        if len(chunks) < 2:
            raise AssertionError(f"stream seed={seed}: {len(chunks)} chunk(s), no steady state")
        log(f"  stream seed={seed}: {frames} frames in {len(chunks)} chunks; TTFA "
            f"{ttfa * 1e3:.2f} ms; steady chunk mean {statistics.mean(gaps) * 1e3:.2f} ms, "
            f"median {statistics.median(gaps) * 1e3:.2f} ms (6 frames = 0.48 s of audio)")

    text, seed = STREAM_REQUESTS[0]
    one, _, _ = run_stream(tts, text, ref, seed, chunk=MAX_FRAMES + 1)
    whole = tts.synthesize(text, ref=ref, max_frames=MAX_FRAMES, seed=seed)
    if len(one) != 1 or one[0].shape != whole.shape:
        raise AssertionError(f"single-chunk stream: {[c.shape for c in one]} vs {whole.shape}")
    err, peak = float(np.abs(one[0] - whole).max()), float(np.abs(whole).max())
    log(f"  single-chunk stream vs synthesize: {whole.shape[1]} samples, max|err| {err:.3e}, "
        f"max|wav| {peak:.3e}")
    if not err <= 1e-4 * peak:
        raise AssertionError(f"single-chunk stream: max|err| {err} > 1e-4 * max|wav| {peak}")
    return launches


def drive_reference_audio(tts, ref):
    """A 10 s WAV from a synthesize output -> Mimi encode on the card ->
    prepare_reference -> a stream from that reference."""
    mcfg, cfg = tts.engine.mimi_cfg, tts.cfg
    wav = tts.synthesize(REQUESTS[1][0], ref=ref, max_frames=MAX_FRAMES, seed=REQUESTS[1][1])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reference.wav")
        clip = wav[:, : 10 * mcfg.sampling_rate]
        tts.save_wav(path, clip * (0.5 / max(float(np.abs(clip).max()), 1e-12)))  # PCM16-audible
        t0 = time.perf_counter()
        codes = tts.encode_reference(ref_audio_path=path)
        log(f"  encode_reference: {codes.shape} codes in {time.perf_counter() - t0:.3f} s")
        if codes.ndim != 2 or codes.shape[1] != cfg.num_codebooks or codes.shape[0] <= 0:
            raise AssertionError(f"encode_reference: codes {codes.shape}")
        if codes.min() < 0 or codes.max() >= cfg.codebook_size:
            raise AssertionError(f"encode_reference: codes out of [0, {cfg.codebook_size})")
        audio_ref = tts.prepare_reference(ref_audio_path=path)
    text, seed = STREAM_REQUESTS[1]
    chunks, ttfa, _ = run_stream(tts, text, audio_ref, seed)
    frames = check_stream(chunks, tts, text, audio_ref, seed, "stream from reference audio")
    log(f"  stream from the audio reference: {frames} frames, TTFA {ttfa * 1e3:.2f} ms")


def mimi_checkpoint_state_dict(tree, cfg):
    """The inverse of `codec.convert.convert_mimi_state_dict`: a Mimi tree
    (with the quantizer's output projections, as `weights.init_mimi_params`
    keeps them) -> the state dict under `transformers.MimiModel`'s names.
    Codebooks go in as embed_sum with unit cluster usage, so the converter
    divides them back exactly."""
    from sopro_tpu_torch.codec.convert import ACOUSTIC, SEMANTIC
    from sopro_tpu_torch.codec.mimi_config import (
        CONV, CONVT, RESNET, decoder_plan, encoder_plan, upsample_spec,
    )

    sd = {}
    c = np.ascontiguousarray

    def conv(name, p):  # HIO [k, in/g, out] -> [out, in/g, k]
        sd[f"{name}.weight"] = c(np.transpose(p["w"], (2, 1, 0)))
        if "b" in p:
            sd[f"{name}.bias"] = p["b"]

    def convt(name, p, groups):  # flipped HIO [k, in/g, g*og] -> [in, og, k]
        k, ig, out = p["w"].shape
        w = np.transpose(p["w"].reshape(k, ig, groups, out // groups), (2, 1, 3, 0))[..., ::-1]
        sd[f"{name}.weight"] = c(w.reshape(groups * ig, out // groups, k))
        if "b" in p:
            sd[f"{name}.bias"] = p["b"]

    def seanet(prefix, params, plan):
        for i, (p, (kind, spec)) in enumerate(zip(params, plan)):
            if kind == CONV:
                conv(f"{prefix}.layers.{i}.conv", p)
            elif kind == CONVT:
                convt(f"{prefix}.layers.{i}.conv", p, int(spec.get("groups", 1)))
            elif kind == RESNET:
                conv(f"{prefix}.layers.{i}.block.1.conv", p["convs"][0])
                conv(f"{prefix}.layers.{i}.block.3.conv", p["convs"][1])

    def transformer(prefix, tf):
        for i, lp in enumerate(tf["layers"]):
            n = f"{prefix}.layers.{i}"
            for key, name in (("ln1", "input_layernorm"), ("ln2", "post_attention_layernorm")):
                sd[f"{n}.{name}.weight"], sd[f"{n}.{name}.bias"] = lp[key]["scale"], lp[key]["bias"]
            for key, name in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                              ("v", "self_attn.v_proj"), ("o", "self_attn.o_proj"),
                              ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
                sd[f"{n}.{name}.weight"] = c(lp[key]["w"].T)
            sd[f"{n}.self_attn_layer_scale.scale"] = lp["scale_attn"]
            sd[f"{n}.mlp_layer_scale.scale"] = lp["scale_mlp"]

    seanet("encoder", tree["encoder"], encoder_plan(cfg))
    seanet("decoder", tree["decoder"], decoder_plan(cfg))
    transformer("encoder_transformer", tree["enc_tf"])
    transformer("decoder_transformer", tree["dec_tf"])
    sd["downsample.conv.weight"] = c(np.transpose(tree["downsample"]["w"], (2, 1, 0)))
    convt("upsample.conv", tree["upsample"], int(upsample_spec(cfg)["groups"]))
    q, ns = tree["quantizer"], cfg.num_semantic_quantizers
    for prefix, rows, proj_in, proj_out in ((SEMANTIC, range(ns), "in_proj_sem", "out_sem"),
                                            (ACOUSTIC, range(ns, cfg.num_quantizers),
                                             "in_proj_ac", "out_ac")):
        for j, qi in enumerate(rows):
            sd[f"{prefix}.layers.{j}.codebook.embed_sum"] = q["embed"][qi]
            sd[f"{prefix}.layers.{j}.codebook.cluster_usage"] = np.ones(cfg.codebook_size, np.float32)
        sd[f"{prefix}.input_proj.weight"] = c(q[proj_in].T[..., None])
        sd[f"{prefix}.output_proj.weight"] = c(q[proj_out].T[..., None])
    return sd


def write_word_tokenizer(path):
    """A WordLevel tokenizer (BOS 1, EOS 2, PAD 0) saved where
    `transformers.AutoTokenizer` finds it."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    vocab = {"<|pad|>": 0, "<s>": 1, "</s>": 2, "<unk>": 3}
    vocab.update({w: 4 + i for i, w in enumerate(("hello", "world", "voice", "test", "card"))})
    tok = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>",
                   "eos_token": "</s>", "pad_token": "<|pad|>", "unk_token": "<unk>"}, f)


def write_mimi_snapshot(mdir, mcfg):
    """The phase-4 Mimi (`init_mimi_params(SEED)`) as a snapshot directory in
    HF names with its config.json."""
    import dataclasses

    from sopro_tpu_torch import hub as H
    from sopro_tpu_torch import weights as W

    os.makedirs(mdir)
    H.write_safetensors(os.path.join(mdir, "model.safetensors"),
                        mimi_checkpoint_state_dict(W.init_mimi_params(SEED, mcfg), mcfg))
    with open(os.path.join(mdir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(mcfg), f)


def drive_checkpoint(tts, ref, ref_tokens, dev, mcfg):
    """save_pretrained of the phase-4 model, a Mimi snapshot in HF names
    from the same seed's tree, both loaded again with every tensor consumed:
    synthesize equal bit for bit; then, where transformers imports, the
    snapshot's BPE tokenizer through from_pretrained."""
    from sopro_tpu_torch.tokenizer import SimpleCharTokenizer
    from sopro_tpu_torch.tts import SoproTTS

    with tempfile.TemporaryDirectory() as tmp:
        sdir, mdir = os.path.join(tmp, "sopro"), os.path.join(tmp, "mimi")
        t0 = time.perf_counter()
        tts.save_pretrained(sdir)
        write_mimi_snapshot(mdir, mcfg)
        sizes = {d: sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d)) for d in (sdir, mdir)}
        t1 = time.perf_counter()
        loaded = SoproTTS.from_pretrained(sdir, mimi_repo_id=mdir, device=dev,
                                          tokenizer=SimpleCharTokenizer(), on_unconsumed="raise")
        t2 = time.perf_counter()
        log(f"  save_pretrained + Mimi snapshot: {sizes[sdir] / 1e6:.1f} + {sizes[mdir] / 1e6:.1f} MB "
            f"in {t1 - t0:.2f} s; from_pretrained (on_unconsumed='raise') {t2 - t1:.2f} s")
        for text, seed in REQUESTS[:2]:
            want = tts.synthesize(text, ref=ref, max_frames=MAX_FRAMES, seed=seed)
            got = loaded.synthesize(text, ref=loaded.prepare_reference(ref_tokens_tq=ref_tokens),
                                    max_frames=MAX_FRAMES, seed=seed)
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"checkpoint: the reloaded model's synthesize (seed={seed}) "
                                     "differs from from_random's")
            log(f"  reloaded synthesize seed={seed}: {got.shape[1]} samples, bit-identical")
        check_hub_keywords(tts, ref, ref_tokens, dev, sdir, mdir, tmp)
        check_warmup(tts, ref, ref_tokens, dev, sdir, mdir)
        try:
            import transformers  # noqa: F401
        except ImportError:
            log("  tokenizer route: transformers does not import here; SimpleCharTokenizer only")
            return
        write_word_tokenizer(sdir)
        bpe = SoproTTS.from_pretrained(sdir, mimi_repo_id=mdir, device=dev, on_unconsumed="raise")
        text = "hello world voice test card"
        ids = bpe.encode_text(text)
        if ids[0] != bpe.tokenizer.bos_id or ids[-1] != bpe.tokenizer.eos_id or len(ids) != 7:
            raise AssertionError(f"BPE tokenizer ids {ids}")
        got = bpe.synthesize(text, ref=ref, max_frames=MAX_FRAMES, seed=5)
        same_ids = SoproTTS(loaded.engine, loaded.cfg, bpe.tokenizer)
        if not np.array_equal(got, same_ids.synthesize(text, ref=ref, max_frames=MAX_FRAMES, seed=5)):
            raise AssertionError("checkpoint: the BPE route differs from the reloaded model")
        log(f"  tokenizer route: transformers AutoTokenizer (TextTokenizer), ids {ids}; "
            f"synthesize {got.shape[1]} samples, equal to the reloaded model fed the same ids")


HUB_SHA = "0123456789abcdef" * 2 + "01234567"  # the commit of the hand-built hub cache


def hub_cache(root, repo_id, files_from):
    """A hub cache entry of `repo_id` under `root` as the hub writes it:
    models--org--name/snapshots/<sha>/ (a copy of `files_from`) and
    refs/main holding the sha."""
    import shutil

    entry = os.path.join(root, "models--" + repo_id.replace("/", "--"))
    shutil.copytree(files_from, os.path.join(entry, "snapshots", HUB_SHA))
    os.makedirs(os.path.join(entry, "refs"))
    with open(os.path.join(entry, "refs", "main"), "w") as f:
        f.write(HUB_SHA)


def check_hub_keywords(tts, ref, ref_tokens, dev, sdir, mdir, tmp):
    """`from_pretrained(dir, revision=, cache_dir=, token=)` on the snapshot
    directories: synthesize equal to phase 4's bit for bit, K1-K3 launched,
    no cache made; where huggingface_hub imports, the same from a hand-built
    hub cache, offline, by repo id (the route taken is printed)."""
    from sopro_tpu_torch import kernels
    from sopro_tpu_torch.tokenizer import SimpleCharTokenizer
    from sopro_tpu_torch.tts import SoproTTS

    text, seed = REQUESTS[0]
    want = tts.synthesize(text, ref=ref, max_frames=MAX_FRAMES, seed=seed)

    def same(loaded, what):
        got = loaded.synthesize(text, ref=loaded.prepare_reference(ref_tokens_tq=ref_tokens),
                                max_frames=MAX_FRAMES, seed=seed)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"checkpoint: {what}'s synthesize differs from phase 4's")
        return got

    unused = os.path.join(tmp, "unused_cache")
    kernels.reset_launches()
    got = same(SoproTTS.from_pretrained(sdir, revision="v1", cache_dir=unused, token="hf_unused",
                                        mimi_repo_id=mdir, device=dev, tokenizer=SimpleCharTokenizer(),
                                        on_unconsumed="raise"), "from_pretrained(revision=, cache_dir=, token=)")
    torch.cuda.synchronize()
    launched("from_pretrained(dir, revision=, cache_dir=, token=) synthesize",
             ("ar_loop", "nar_heads", "seanet"))
    if os.path.exists(unused):
        raise AssertionError("checkpoint: cache_dir was made for local snapshot directories")
    log(f"  from_pretrained(dir, revision='v1', cache_dir=..., token=...): {got.shape[1]} samples, "
        "bit-identical to phase 4; no cache made")
    try:
        import huggingface_hub
        import huggingface_hub.constants
        from huggingface_hub.utils import reset_sessions
    except ImportError:
        log("  hub route: huggingface_hub does not import here; local snapshot directories only")
        return
    # the hub is read offline, from the cache written here (main sets HF_HUB_OFFLINE=1 first)
    huggingface_hub.constants.HF_HUB_OFFLINE = True
    reset_sessions()
    cache = os.path.join(tmp, "hub_cache")
    hub_cache(cache, "org/sopro", sdir)
    hub_cache(cache, "kyutai/mimi", mdir)  # the Mimi's default repo id
    kernels.reset_launches()
    got = same(SoproTTS.from_pretrained("org/sopro", cache_dir=cache, device=dev,
                                        tokenizer=SimpleCharTokenizer(), on_unconsumed="raise"),
               "from_pretrained('org/sopro', cache_dir=...)")
    torch.cuda.synchronize()
    launched("hub-cache synthesize", ("ar_loop", "nar_heads", "seanet"))
    log(f"  hub route: huggingface_hub {huggingface_hub.__version__} offline, 'org/sopro' and "
        f"'kyutai/mimi' from a hand-built cache: {got.shape[1]} samples, bit-identical to phase 4")


def check_warmup(tts, ref, ref_tokens, dev, sdir, mdir):
    """`from_pretrained(warmup=True)` launches K1-K4; the request and the
    stream after it build nothing (the kernel libraries loaded, K1's weight
    streams, K2's head stacks and the SEANet pack are the objects warmup
    made) and equal phase 4's model."""
    from sopro_tpu_torch import kernels
    from sopro_tpu_torch.tokenizer import SimpleCharTokenizer
    from sopro_tpu_torch.tts import SoproTTS

    kernels.reset_launches()
    t0 = time.perf_counter()
    warm = SoproTTS.from_pretrained(sdir, mimi_repo_id=mdir, device=dev,
                                    tokenizer=SimpleCharTokenizer(), warmup=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launched("from_pretrained(warmup=True)", ("ar_loop", "nar_heads", "seanet", "seanet_chunk"))

    def built():
        m = warm.engine.model
        return (dict(m.ar._streams), m.ar._stacked, m.nar._stacks, warm.engine.mimi._packed,
                dict(kernels._LIBS))

    before = built()
    text, seed = REQUESTS[0]
    wref = warm.prepare_reference(ref_tokens_tq=ref_tokens)
    t2 = time.perf_counter()
    got = warm.synthesize(text, ref=wref, max_frames=MAX_FRAMES, seed=seed)
    t3 = time.perf_counter()
    chunks, _, _ = run_stream(warm, STREAM_REQUESTS[0][0], wref, STREAM_REQUESTS[0][1])
    after = built()
    same = (after[0].keys() == before[0].keys() and all(after[0][k] is v for k, v in before[0].items())
            and all(a is b for a, b in zip(after[1:4], before[1:4]))
            and after[4].keys() == before[4].keys())
    if not same:
        raise AssertionError("warmup: the first request after from_pretrained(warmup=True) built "
                             "a kernel library or a weight pack")
    want = tts.synthesize(text, ref=ref, max_frames=MAX_FRAMES, seed=seed)
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError("warmup: the warmed model's synthesize differs from phase 4's")
    log(f"  from_pretrained(warmup=True): {t1 - t0:.2f} s (K1-K4 launched); the first request "
        f"{(t3 - t2) * 1e3:.1f} ms and a {len(chunks)}-chunk stream after it built nothing "
        "(same libraries, K1 streams, K2 stacks, SEANet pack); synthesize bit-identical to phase 4")


SERVE_TEXTS = [f"Session number {i} speaks on a shared card, each with its own seed." for i in range(12)]
# the burst's caps: the short ones finish early, so the later four join mid-flight
SERVE_MAX = (400, 400, 400, 400, 96, 144, 192, 240, 400, 400, 400, 400)
SERVE_SEEDS = tuple(100 + i for i in range(12))
SERVE_TEXT_BUCKET = 256  # the server's default bucket


def collect(handle):
    """Drain a session in a thread -> (list of (perf_counter, chunk), thread)."""
    import threading

    got = []

    def run():
        for c in handle.chunks():
            got.append((time.perf_counter(), c))

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return got, th


def run_batcher_alone(tts, ref, i, **kw):
    """Session i alone in a fresh batcher -> its chunks."""
    from sopro_tpu_torch.serve import ContinuousBatcher

    b = ContinuousBatcher(tts, **kw)
    try:
        h = b.submit(SERVE_TEXTS[i], ref, seed=SERVE_SEEDS[i], max_frames=SERVE_MAX[i])
        return list(h.chunks())
    finally:
        b.stop()


# K1's rows held against the plain loop: each at its own age (t), one stopped (a free slot);
# row i of more than 8 at SERVE_AGES[i % 8] + 5 * (i // 8)
SERVE_AGES = (0, 3, 17, 40, 1, 120, 250, 380)
SERVE_STOPPED = 5
# K1's row sweep: 8 serving rows and beyond (rows past 8 repeat the 8 slots' texts)
K1_ROWS = (1, 4, 7, 8, 16, 32)


def serve_rows_state(cfg, b, s, dev, rng):
    """A K1 state of b serving rows at SERVE_AGES: the row's last token and
    a history of earlier tokens where t > 0, a random conv state, row
    SERVE_STOPPED stopped."""
    from sopro_tpu_torch.models import sopro as M

    c = M.init_ar_carry(cfg, b, s, 7, dev)
    st = {k: getattr(c, k) for k in ("t", "last", "streak", "stopped", "first_eos", "key", "hist",
                                     "bufs")}
    ages = np.asarray([SERVE_AGES[i % 8] + 5 * (i // 8) for i in range(b)], np.int32)
    st["t"] = torch.from_numpy(ages).to(dev)
    toks = rng.integers(0, cfg.codebook_size, (b, st["hist"].shape[1] + 1)).astype(np.int32)
    st["last"] = torch.from_numpy(np.where(ages > 0, toks[:, -1], 0)).to(dev)
    hist = np.where(np.arange(st["hist"].shape[1])[None] >= st["hist"].shape[1] - ages[:, None],
                    toks[:, :-1], -1)
    st["hist"] = torch.from_numpy(hist.astype(np.int32)).to(dev)
    st["bufs"] = torch.from_numpy(
        rng.standard_normal(tuple(st["bufs"].shape)).astype(np.float32) * 0.3).to(dev)
    if b > SERVE_STOPPED:
        st["stopped"][SERVE_STOPPED] = 1
    return st


def check_ar_loop_rows(tts, st, dev, rng):
    """K1 at K1_ROWS rows of the serving state (text bucket 256, S = 401, the
    stacked text KV the batcher keeps; rows past 8 repeat the 8 slots'
    texts): µs per step over 64 steps and the launch facts (blocks of one
    launch over the card's SMs, rows a step takes at once, row groups,
    waves). Each also held against ar_loop_plain over the 64 steps from
    `serve_rows_state`, with per-row near-greedy settings and
    min_gen, anti-loop on with recovery = the normal settings (a session
    with anti_loop off, as the tick runs it): tokens and state equal, the
    conv state within 1e-4 of its peak."""
    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.ops.ar_loop import ar_loop, ar_loop_plain, launch_info

    out = {}
    steps = 64
    with torch.inference_mode():
        for b in K1_ROWS:
            idx = torch.tensor([i % st.cond.shape[0] for i in range(b)], device=dev)
            ctx = M.ar_context_from_kv(tts.engine.model, st.kv_k[:, idx].contiguous(),
                                       st.kv_v[:, idx].contiguous(), st.text_mask[idx].clone())
            cond = st.cond[idx].contiguous()

            def fresh():
                c = M.init_ar_carry(tts.cfg, b, cond.shape[1], 7, dev)
                return {k: getattr(c, k) for k in ("t", "last", "streak", "stopped", "first_eos",
                                                   "key", "hist", "bufs")}

            per_row = M.ARSettings().per_row(b, dev)
            ms = cuda_ms(lambda: ar_loop(ctx, cond, fresh(), per_row, steps, True), 5)
            _, state = ar_loop(ctx, cond, fresh(), per_row, steps, True)
            done = int(state["t"].min())
            facts = launch_info(ctx, cond, fresh(), per_row)
            if facts["waves"] != 1 or facts["blocks"] != facts["sms"]:
                raise AssertionError(f"K1 at B={b}: not one launch over every SM in one wave: {facts}")
            out[b] = {"us_per_step": ms * 1e3 / steps, "steps": done, "launch": facts}
            log(f"  K1 at B={b} (text bucket {ctx.mask.shape[1]}): "
                f"{ms * 1e3 / steps:.1f} µs per step over {steps} steps (every row ran {done}); "
                f"{facts['blocks']} blocks on {facts['sms']} SMs, {facts['row_groups']} group(s) of "
                f"{facts['rows_per_group']} rows, {facts['waves']} wave, "
                f"{'streamed' if facts['streamed'] else 'resident'} weights "
                f"({facts['resident_chunks']} of {facts['chunks']} chunks resident)")
            greedy = torch.tensor([1e-4 * (1 + i) for i in range(b)], device=dev)
            top_p = torch.tensor([(0.9, 0.5, 0.95, 0.7)[i % 4] for i in range(b)], device=dev)
            sett = M.ARSettings(top_p=top_p, temperature=greedy, recovery_top_p=top_p,
                                recovery_temp=greedy,
                                min_gen_frames=torch.tensor([1 + 7 * i for i in range(b)]))
            per_row = sett.per_row(b, dev)
            start = serve_rows_state(tts.cfg, b, cond.shape[1], dev, rng)
            tk, sk = ar_loop(ctx, cond, dict(start), per_row, steps, True)
            tp, sp = ar_loop_plain(ctx, cond, dict(start), per_row, steps, True)
            torch.cuda.synchronize()
            what = f"K1 at B={b}, rows at t={start['t'].tolist()}, near-greedy per row"
            if not torch.equal(tk, tp):
                rows = sorted(set((tk != tp).nonzero()[:, 0].tolist()))
                raise AssertionError(f"{what}: tokens differ from ar_loop_plain in rows {rows}")
            for k in ("t", "last", "streak", "stopped", "first_eos", "key", "hist"):
                if not torch.equal(sk[k], sp[k]):
                    raise AssertionError(f"{what}: state {k} differs from ar_loop_plain")
            err, peak = float((sk["bufs"] - sp["bufs"]).abs().max()), float(sp["bufs"].abs().max())
            if not err <= 1e-4 * peak:
                raise AssertionError(f"{what}: conv state max|err| {err} > 1e-4 * peak {peak}")
            out[b].update(plain_max_abs_err=err, plain_t=sp["t"].tolist())
            log(f"  {what}: tokens and state equal to ar_loop_plain over {steps} steps (t after: "
                f"{sp['t'].tolist()}), conv-state max|err| {err:.3e}, peak {peak:.3e}")
    return out


# the serve tick's NAR window at 8 slots, each row at its own age: frames emitted so far
SERVE_EMITTED = (0, 16, 48, 100, 181, 250, 384, 400)


def check_nar_tick(tts, st, dev):
    """K2 as the serve tick runs it, on pass B's state: the window that
    `engine.serve_window` gathers across 8 slots at SERVE_EMITTED (8 x 197
    rows per stage, the last stage's heads on the 8 x 16 tail rows). The
    gather equals per-row slices zero-padded as the stream cuts them; per
    stage, ids equal to the plain version's wherever the top-2 margin is
    above 1e-5, and the stages' ids equal to `nar_refine`'s; kernel and
    plain version timed per stage."""
    import torch.nn.functional as F

    from sopro_tpu_torch.bench_kernels import bound, nar_cost
    from sopro_tpu_torch.engine import serve_window
    from sopro_tpu_torch.models import nar as N
    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.ops.nar_heads import nar_heads_argmax, nar_heads_argmax_plain

    model, cfg = tts.engine.model, tts.cfg
    cf, ctx_frames = 16, int(cfg.rf_nar())
    w, c, s = cf + ctx_frames, st.carry, st.cond.shape[1]
    out = {"ms": 0.0, "plain_ms": 0.0, "rows": [], "mismatches": 0, "max_abs_err": 0.0}
    flop = nbytes = 0.0
    with torch.inference_mode():
        emitted = torch.tensor(SERVE_EMITTED, dtype=torch.int32, device=dev)
        valid = torch.minimum(torch.minimum(c.first_eos, c.t), st.rows["max_frames"] + 1)
        win, rvq, mask = serve_window(st.cond, c.tokens, emitted, valid, cf, ctx_frames)
        for i, e in enumerate(SERVE_EMITTED):
            lo, hi = e - ctx_frames, e + cf
            pad = (max(0, -lo), max(0, hi - s))
            if not (torch.equal(win[i], F.pad(st.cond[i, max(lo, 0): min(hi, s)], (0, 0) + pad))
                    and torch.equal(rvq[i], F.pad(c.tokens[i, max(lo, 0): min(hi, s)], pad))):
                raise AssertionError(f"serve window row {i} (emitted {e}): the gather differs "
                                     "from the row's own slice")
        path = M.nar_refine(model, win, rvq, mask=mask, head_tail=cf)
        shared, stages, idx = model.shared.p, cfg.stage_order(), cfg.stage_indices()
        prev_tokens, prev_cbs = rvq[..., None].to(torch.int32), [0]
        for stage in stages:
            tail = cf if stage == stages[-1] else None
            prev_emb = N.cb_sum_embed_subset(shared["cb_embed"], M.cb_spec(cfg), prev_tokens,
                                             prev_cbs, cb_weights=shared["nar_prev_cb_weights"])
            z = N._stage_hidden(model.nar.p, cfg, stage, win, prev_emb, mask, tail).contiguous()
            hid, wst, bst, packed = model.nar.head_stacks()[stage]
            got = nar_heads_argmax(z, hid, wst, bst, packed)
            want = nar_heads_argmax_plain(z, hid, wst, bst)
            logits = torch.einsum("bthd,hdv->bthv", (z[:, :, None, :] + hid[None, None]).double(),
                                  wst.double()) + bst[None, None].double()
            top2 = torch.topk(logits, 2, dim=-1).values
            differ = got != want
            bad = int((differ & (top2[..., 0] - top2[..., 1] > 1e-5)).sum())
            if bad:
                raise AssertionError(f"nar_heads at the serve tick, stage {stage}: {bad} ids "
                                     "differ at a clear margin")
            if not torch.equal(got, path[:, w - got.shape[1]:, idx[stage]]):
                raise AssertionError(f"nar_heads at the serve tick, stage {stage}: the ids differ "
                                     "from nar_refine's")
            gl = torch.gather(logits, -1, got.long()[..., None])[..., 0]
            out["max_abs_err"] = max(out["max_abs_err"], float((top2[..., 0] - gl).max()))
            out["mismatches"] += int(differ.sum())
            out["ms"] += cuda_ms(lambda: nar_heads_argmax(z, hid, wst, bst, packed), 20)
            out["plain_ms"] += cuda_ms(lambda: nar_heads_argmax_plain(z, hid, wst, bst), 20)
            rows = z.shape[0] * z.shape[1]
            out["rows"].append(rows)
            f, n = nar_cost(rows, *wst.shape)
            flop, nbytes = flop + f, nbytes + n
            if stage != stages[-1]:
                prev_tokens = torch.cat([prev_tokens, got], dim=-1)
                prev_cbs = prev_cbs + list(idx[stage])
    out.update(bound(flop, nbytes, tf32x3=True), library_ms=out["plain_ms"])
    log(f"  nar_heads at the serve tick (rows per stage {out['rows']}, emitted {SERVE_EMITTED}): "
        f"gather equal to per-row slices, ids equal to nar_refine's and to plain's but "
        f"{out['mismatches']} near-ties (worst float64 logit gap {out['max_abs_err']:.3e}); "
        f"{out['ms']:.3f} ms (kernel) vs {out['plain_ms']:.3f} ms (plain = einsum + argmax); "
        f"bound {out['bound_ms']:.4f} ms ({out['bound_rate']})")
    return out


def drive_serve(tts, ref, dev, rng):
    """Phase 10: pass A (production defaults, 12 sessions on 8 slots),
    sessions again alone, pass B (ramp off, against tts.stream), HTTP."""
    import socket
    import urllib.request

    from sopro_tpu_torch import kernels
    from sopro_tpu_torch.serve import ContinuousBatcher
    from sopro_tpu_torch.serve import server as core
    from sopro_tpu_torch.serve import server_stdlib as srv

    hop, sr = tts.engine.mimi_cfg.hop_length, tts.engine.mimi_cfg.sampling_rate
    prod = dict(slots=8, chunk_frames=16, ramp_frames=4, text_bucket=SERVE_TEXT_BUCKET, max_frames=MAX_FRAMES,
                pcm16=True)
    serve_b = b = ContinuousBatcher(tts, **prod)  # serves the HTTP requests at the end too
    t0 = time.perf_counter()
    b.warmup()
    torch.cuda.synchronize()
    log(f"  warmup over ref buckets {tts.engine.rt.ref_buckets}: {time.perf_counter() - t0:.2f} s")

    b.reset_stats()  # stats() below count pass A's traffic only
    kernels.reset_launches()
    t0 = time.perf_counter()
    handles = [b.submit(SERVE_TEXTS[i], ref, seed=SERVE_SEEDS[i], max_frames=SERVE_MAX[i])
               for i in range(8)]
    runs = [collect(h) for h in handles]
    while len(runs[0][0]) < 3:  # the burst is decoding
        time.sleep(0.005)
    handles += [b.submit(SERVE_TEXTS[i], ref, seed=SERVE_SEEDS[i], max_frames=SERVE_MAX[i])
                for i in range(8, 12)]
    runs += [collect(h) for h in handles[8:]]
    for _, th in runs:
        th.join(timeout=600)
        if th.is_alive():
            raise AssertionError("serve pass A: a session did not finish")
    wall = time.perf_counter() - t0
    launches = launched("serve", ("ar_loop", "nar_heads", "seanet_chunk"))
    if launches["seanet"] or launches["ar_step"]:
        raise AssertionError(f"serve pass A launched K3 or K5: {launches}")
    stats = b.stats()
    if stats["ticks"] != launches["ar_loop"] or stats["sessions_done"] != 12:
        raise AssertionError(f"serve pass A: stats count {stats['ticks']} ticks and "
                             f"{stats['sessions_done']} sessions; K1 launched "
                             f"{launches['ar_loop']} times for 12 sessions")
    ttfa = [h.first_chunk_s * 1e3 for h in handles]
    audio_s = 0.0
    gaps = []
    for i, (got, _) in enumerate(runs):
        chunks = [c for _, c in got]
        frames = sum(c.shape[1] for c in chunks) // hop
        if chunks[0].shape[1] != 4 * hop or any(c.shape[1] != 16 * hop for c in chunks[1:-1]):
            raise AssertionError(f"serve session {i}: chunk grid {[c.shape[1] // hop for c in chunks]}")
        if any(c.dtype != np.int16 for c in chunks):
            raise AssertionError(f"serve session {i}: not int16 PCM")
        want = tts.generate_tokens(SERVE_TEXTS[i], ref, max_frames=SERVE_MAX[i],
                                   seed=SERVE_SEEDS[i]).shape[0]
        if frames != want:
            raise AssertionError(f"serve session {i}: {frames} frames, generate_tokens gives {want}")
        stamps = [t for t, _ in got]
        gaps.append(float(np.mean(np.diff(stamps[1:]))) * 1e3 if len(stamps) > 2 else float("nan"))
        audio_s += frames * hop / sr
    log(f"  pass A: 12 sessions on 8 slots, {audio_s:.2f} s of audio in {wall:.3f} s = "
        f"{audio_s / wall:.1f} s of audio per second; ticks {stats['ticks']} (ramp "
        f"{stats['ramp_ticks']}), admit groups {stats['admit_groups']}")
    log(f"  pass A: tick dispatch p50 {stats['tick_dispatch_ms_p50']} ms, read p50 "
        f"{stats['tick_read_ms_p50']} ms; TTFA p50 {stats['ttfa_p50_ms']} ms = prep "
        f"{stats['ttfa_prep_p50_ms']} + queue {stats['ttfa_queue_p50_ms']} + admit->tick "
        f"{stats['ttfa_admit_tick_p50_ms']} + tick->chunk {stats['ttfa_tick_chunk_p50_ms']} ms")
    log(f"  pass A: TTFA per session, ms: {[round(x, 2) for x in ttfa]}; the 8-way burst's p50 "
        f"{statistics.median(ttfa[:8]):.2f} ms, the 4 joiners' {statistics.median(ttfa[8:]):.2f} ms")
    log(f"  pass A: steady chunk gap per session, ms: {[round(g, 2) for g in gaps]}")
    for i in (0, 4, 9):  # a full burst session, a short one, a mid-flight joiner
        alone = np.concatenate(run_batcher_alone(tts, ref, i, **prod), axis=1)
        mixed = np.concatenate([c for _, c in runs[i][0]], axis=1)
        diff = int(np.abs(alone.astype(np.int32) - mixed.astype(np.int32)).max(initial=0))
        log(f"  session {i} alone in a fresh batcher: {alone.shape[1] // hop} frames, max "
            f"|PCM difference| {diff} LSB")
        if alone.shape != mixed.shape or diff > 1:
            raise AssertionError(f"serve session {i}: alone differs from co-resident by {diff} LSB")
    result = dict(stats=stats, launches=launches, sessions=12, audio_s_per_s=audio_s / wall,
                  gaps_ms=gaps, ttfa_ms=ttfa)

    log("  pass B: ramp off, 8 sessions against tts.stream (chunk 16)")
    b = ContinuousBatcher(tts, **dict(prod, ramp_frames=16, pcm16=False))
    try:
        hs = [b.submit(SERVE_TEXTS[i], ref, seed=SERVE_SEEDS[i], max_frames=SERVE_MAX[i])
              for i in range(8)]
        outs = [np.concatenate(list(h.chunks()), axis=1) for h in hs]
    finally:
        b.stop()
    ar_tokens = b.state.carry.tokens.cpu().numpy()  # session i joined slot i
    result["k1_rows"] = check_ar_loop_rows(tts, b.state, dev, rng)
    result["k2_tick"] = check_nar_tick(tts, b.state, dev)
    bad = []
    for i, out in enumerate(outs):
        solo = np.concatenate(list(tts.stream(SERVE_TEXTS[i], ref=ref, max_frames=SERVE_MAX[i],
                                              chunk_frames=16, seed=SERVE_SEEDS[i])), axis=1)
        if out.shape != solo.shape:
            raise AssertionError(f"serve pass B session {i}: {out.shape} vs {solo.shape}")
        diff, peak = np.abs(out - solo)[0], float(np.abs(solo).max())
        frames = sorted(set((np.nonzero(diff > 1e-4 * peak)[0] // hop).tolist()))
        want = tts.generate_tokens(SERVE_TEXTS[i], ref, max_frames=SERVE_MAX[i], seed=SERVE_SEEDS[i])
        same_ar = np.array_equal(ar_tokens[i, : want.shape[0]], want[:, 0])
        log(f"  pass B session {i}: {out.shape[1] // hop} frames, AR tokens "
            f"{'equal to' if same_ar else 'DIFFER from'} generate_tokens', max|err| / peak "
            f"{float(diff.max()) / peak:.2e}" + (f", frames past 1e-4: {frames}" if frames else ""))
        bad += [i] if frames else []
        if not same_ar:
            raise AssertionError(f"serve pass B session {i}: AR tokens differ from generate_tokens")
    if bad:
        raise AssertionError(f"serve pass B: sessions {bad} differ from their solo streams")

    log("  HTTP: server_stdlib on 127.0.0.1 over pass A's model and batcher")
    core._tts, core._batcher = tts, serve_b
    done = serve_b.stats()["sessions_done"]
    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        port = s_.getsockname()[1]
    httpd = srv.serve("127.0.0.1", port)
    base = f"http://127.0.0.1:{port}"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            core.CFG.ref_cache_dir = tmp
            clip = tts.synthesize(REQUESTS[1][0], ref=ref, max_frames=MAX_FRAMES, seed=2)[:, : 10 * sr]
            wav_bytes = core.wav_bytes_from_float(clip * (0.5 / max(float(np.abs(clip).max()), 1e-12)), sr)
            boundary = "smokeboundary"

            def post(path, fields, files=None):
                parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'
                         .encode() for k, v in fields.items()]
                parts += [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"; filename="{fn}"'
                          f"\r\nContent-Type: application/octet-stream\r\n\r\n".encode() + d + b"\r\n"
                          for k, (fn, d) in (files or {}).items()]
                req = urllib.request.Request(
                    base + path, data=b"".join(parts) + f"--{boundary}--\r\n".encode(),
                    headers={"Content-Type": f"multipart/form-data; boundary={boundary}"},
                    method="POST")
                with urllib.request.urlopen(req, timeout=300) as r:
                    return r.status, dict(r.headers), r.read()

            t1 = time.perf_counter()
            code, _, body = post("/v1/reference/cache", {}, {"ref_audio": ("ref.wav", wav_bytes)})
            rid = json.loads(body)["ref_id"]
            log(f"  POST /v1/reference/cache (10 s WAV): {code}, {time.perf_counter() - t1:.3f} s")
            for path, name, ctype in (("/", "index.html", "text/html"),
                                      ("/static/app.js", "app.js", "text/javascript")):
                with urllib.request.urlopen(base + path, timeout=60) as r:
                    page, got_type = r.read(), r.headers["Content-Type"]
                with open(os.path.join(core.STATIC_DIR, name), "rb") as f:
                    if r.status != 200 or got_type != ctype or page != f.read():
                        raise AssertionError(f"HTTP GET {path}: {r.status} {got_type}, "
                                             f"{len(page)} bytes not the package's {name}")
                log(f"  GET {path}: 200, {got_type}, {len(page)} bytes equal to static/{name}")
            t1 = time.perf_counter()
            kernels.reset_launches()
            code2, _, data = post("/v1/audio/speech", {"input": SERVE_TEXTS[0], "ref_id": rid,
                                                       "stream": "true", "max_frames": "64"})
            torch.cuda.synchronize()
            launched("HTTP speech stream", ("ar_loop", "nar_heads", "seanet_chunk"))
            if data[:4] != b"SPRO" or struct.unpack("<II", data[4:12]) != (sr, 1):
                raise AssertionError("HTTP stream: bad SPRO header")
            off, total = 12, 0
            while off < len(data):
                (n,) = struct.unpack("<I", data[off: off + 4])
                off, total = off + 4 + n, total + n
            want = (min(64, MAX_FRAMES) + 1) * hop * 2  # random weights run to the cap
            if off != len(data) or total != want:
                raise AssertionError(f"HTTP stream: {total} PCM bytes, want {want}")
            log(f"  POST /v1/audio/speech stream=true: {code2}, {total // 2} samples in SPRO frames, "
                f"{time.perf_counter() - t1:.3f} s")
            code3, headers, body = post("/v1/audio/speech", {"input": SERVE_TEXTS[1], "ref_id": rid,
                                                             "stream": "false", "max_frames": "64"})
            if body[:4] != b"RIFF" or not headers["Content-Type"].startswith("audio/wav"):
                raise AssertionError("HTTP: stream=false did not answer a WAV")
            log(f"  POST /v1/audio/speech stream=false: {code3}, {len(body)} bytes of WAV")
            with urllib.request.urlopen(base + "/v1/stats", timeout=60) as r:
                code4, st = r.status, json.loads(r.read())
            log(f"  GET /v1/stats: {code4}, sessions_done {st['sessions_done']}")
            if (code, code2, code3, code4) != (200, 200, 200, 200) or st["sessions_done"] != done + 2:
                raise AssertionError(f"HTTP: answers {(code, code2, code3, code4)}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        serve_b.stop()
    result["concurrent_submits"] = check_concurrent_submits(tts, ref, prod)
    return result


CONCURRENT_CAP = 32  # frames per session of the 12 concurrent submits


def check_concurrent_submits(tts, ref, prod):
    """12 client threads released by one barrier submit into one fresh
    batcher: exactly one scheduler thread ("sopro-batcher") is seen while
    they run, and every session completes with `generate_tokens`' frame
    count."""
    import threading

    from sopro_tpu_torch.serve import ContinuousBatcher
    from sopro_tpu_torch.serve.scheduler import THREAD_NAME

    hop = tts.engine.mimi_cfg.hop_length
    running = lambda: [th for th in threading.enumerate() if th.name == THREAD_NAME and th.is_alive()]
    if running():
        raise AssertionError(f"concurrent submits: scheduler threads alive before: {running()}")
    b = ContinuousBatcher(tts, **prod)
    barrier, handles, seen = threading.Barrier(12), {}, []

    def client(i):
        barrier.wait()
        handles[i] = b.submit(SERVE_TEXTS[i], ref, seed=SERVE_SEEDS[i], max_frames=CONCURRENT_CAP)
        seen.append(len(running()))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        sys.setswitchinterval(interval)
        if len(handles) != 12:
            raise AssertionError(f"concurrent submits: {len(handles)} of 12 submitted")
        seen.append(len(running()))
        frames = []
        for i in range(12):
            chunks = list(handles[i].chunks())
            frames.append(sum(c.shape[1] for c in chunks) // hop)
        seen.append(len(running()))
        wall = time.perf_counter() - t0
    finally:
        sys.setswitchinterval(interval)
        b.stop()
    want = [tts.generate_tokens(SERVE_TEXTS[i], ref, max_frames=CONCURRENT_CAP,
                                seed=SERVE_SEEDS[i]).shape[0] for i in range(12)]
    if set(seen) != {1} or frames != want or b.stats()["sessions_done"] != 12 or running():
        raise AssertionError(f"concurrent submits: scheduler threads seen {sorted(set(seen))}, "
                             f"frames {frames} against {want}, "
                             f"{b.stats()['sessions_done']} sessions done")
    log(f"  12 threads submitting at once: one {THREAD_NAME} thread at every look "
        f"({len(seen)} looks), 12 sessions of {frames[0]} frames done in {wall:.3f} s")
    return {"sessions": 12, "scheduler_threads": 1, "wall_s": wall}


# phase 11: rows of S = 401 frames (row 0 fills S: no EOS target), texts and references cut per row
TRAIN_S = MAX_FRAMES + 1
TRAIN_LENGTHS = (TRAIN_S, 396, 350, 301, 262, 233, 180, 121)
TRAIN_TEXT_LENGTHS = (64, 60, 57, 52, 48, 44, 40, 33)
TRAIN_REF_LENGTHS = (150, 150, 150, 140, 130, 120, 110, 100)
TRAIN_STEPS, TRAIN_WARM = 20, 3
TRAIN_CPU_ROWS = [0, 3]  # the card-vs-CPU step: the full row and one with an EOS target
# the card against the CPU, both fp32 with TF32 off; sums run in other orders
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4  # of each leaf's largest |gradient|, plus 1e-6 of the largest of all leaves


def train_batch(cfg, rng):
    """The numpy-seeded B = 8 training batch on the host."""
    from sopro_tpu_torch.train import TrainBatch

    b, l, tr = len(TRAIN_LENGTHS), max(TRAIN_TEXT_LENGTHS), max(TRAIN_REF_LENGTHS)
    q, v = cfg.num_codebooks, cfg.codebook_size

    def mask(n, lengths):
        return torch.from_numpy(np.arange(n)[None] < np.array(lengths)[:, None])

    return TrainBatch(
        text_ids=torch.from_numpy(rng.integers(4, 259, (b, l)).astype(np.int32)),
        text_mask=mask(l, TRAIN_TEXT_LENGTHS),
        ref_tokens=torch.from_numpy(rng.integers(0, v, (b, tr, q)).astype(np.int32)),
        ref_mask=mask(tr, TRAIN_REF_LENGTHS),
        frames=torch.from_numpy(rng.integers(0, v, (b, TRAIN_S, q)).astype(np.int32)),
        frame_mask=mask(TRAIN_S, TRAIN_LENGTHS),
    )


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for the bit-for-bit comparisons of training
    steps (the default CUDA backward of some ops adds with atomics)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def same_state(a, b, what):
    """Raise unless two models' parameters are equal bit for bit."""
    pb = dict(b.named_parameters())
    bad = [n for n, p in a.named_parameters() if not torch.equal(p.detach().cpu(), pb[n].detach().cpu())]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} parameters differ, e.g. {bad[:3]}")


def same_metrics(got, want, what):
    if any(not torch.equal(got[k].cpu(), want[k].cpu()) for k in want):
        raise AssertionError(f"{what}: metrics {({k: float(v) for k, v in got.items()})} vs "
                             f"{({k: float(v) for k, v in want.items()})}")


def profile_steps(step, batch, n=2):
    """n steps under torch.profiler -> (the kernels' busy share of the host
    wall, kernel launches per step, stream / device / event synchronisations
    per step, the largest kernels by device ms per step, the host wall per
    step in seconds). User annotations
    (optimizer ranges) are not kernels and are left out of the sums; a
    `.item()` on a CPU tensor (AdamW's step counts) is not a sync."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False) and "#" not in e.key]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6 / wall
    launches = sum(e.count for e in kernels) / n
    syncs = (sum(e.count for e in rows if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                                                      "cudaEventSynchronize")) - 1) / n  # less the last one
    top = sorted(((e.key, e.self_device_time_total / 1e3 / n) for e in kernels), key=lambda r: -r[1])
    return busy, launches, syncs, top[:8], wall / n


def step_phases(model, opt, batch):
    """One training step split into forward, backward and the optimizer
    (with `weights_changed`): per phase the host's ms to dispatch it and the
    ms between CUDA events around it."""
    from sopro_tpu_torch import train as T

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    host = []
    torch.cuda.synchronize()
    opt.zero_grad(set_to_none=False)
    t = time.perf_counter()
    ev[0].record()
    loss, _ = T.loss_fn(model, batch)
    ev[1].record()
    host.append(time.perf_counter() - t)
    t = time.perf_counter()
    loss.backward()
    ev[2].record()
    host.append(time.perf_counter() - t)
    t = time.perf_counter()
    T.fill_missing_grads(opt)
    opt.step()
    model.weights_changed()
    ev[3].record()
    host.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return {name: (h * 1e3, ev[i].elapsed_time(ev[i + 1]))
            for i, (name, h) in enumerate(zip(("forward", "backward", "optimizer"), host))}


def drive_train(tts, ref_tokens, dev, rng, cfg, mcfg):
    """Phase 11: the card against the CPU, 20 timed steps, the NCCL world-1
    step, resume, and serving from the trained model."""
    import torch.distributed as dist

    from sopro_tpu_torch import kernels
    from sopro_tpu_torch import parallel as P
    from sopro_tpu_torch import profiling as PR
    from sopro_tpu_torch import train as T
    from sopro_tpu_torch import weights as W
    from sopro_tpu_torch.bench_kernels import PEAK_FP32
    from sopro_tpu_torch.engine import Engine
    from sopro_tpu_torch.tokenizer import SimpleCharTokenizer
    from sopro_tpu_torch.tts import SoproTTS

    tree = W.init_sopro_params(SEED + 11, cfg, 259)
    W.fill_zero_inits(tree, None, SEED + 12)
    host_batch = train_batch(cfg, rng)
    batch = host_batch.to(dev)
    b, l, tr = (int(x) for x in host_batch.text_ids.shape + host_batch.ref_tokens.shape[1:2])
    out = {}

    # one B = 2 step's loss and gradients, the card against the CPU
    pair = T.TrainBatch(*(x[TRAIN_CPU_ROWS] for x in host_batch))
    seen = []
    for d in ("cpu", dev):
        m = W.sopro_params_from_jax(tree, cfg, d)
        t0 = time.perf_counter()
        loss, _ = T.loss_fn(m, pair.to(d))
        loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
                 for n, p in m.named_parameters()}
        seen.append((float(loss.detach()), grads))
        log(f"  B = 2 loss and backward on {d}: loss {seen[-1][0]:.6f}, "
            f"{time.perf_counter() - t0:.2f} s")
        del m
    (l_cpu, g_cpu), (l_gpu, g_gpu) = seen
    gmax = max(float(g.abs().max()) for g in g_cpu.values())
    ratio, leaf = max((float((g_gpu[n] - g).abs().max())
                       / (TRAIN_GRAD_TOL * float(g.abs().max()) + 1e-6 * gmax), n)
                      for n, g in g_cpu.items())
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    log(f"  card vs CPU: loss rel err {loss_rel:.2e} (tol {TRAIN_LOSS_RTOL}); worst leaf {leaf}: "
        f"grad err {ratio:.3f} of its tolerance ({TRAIN_GRAD_TOL} x its peak + 1e-6 x {gmax:.3e}), "
        f"{len(g_cpu)} leaves")
    if not loss_rel <= TRAIN_LOSS_RTOL or not ratio <= 1.0:
        raise AssertionError(f"train: the card's step differs from the CPU's (loss {loss_rel:.2e}, "
                             f"leaf {leaf} at {ratio:.3f} of its tolerance)")
    out.update(cpu_loss_rel_err=loss_rel, cpu_grad_err_of_tol=ratio)
    del seen, g_cpu, g_gpu

    # the model that trains serves first, so K1's weight stream and K2's packs exist
    model = W.sopro_params_from_jax(tree, cfg, dev)
    trained = SoproTTS(Engine(model, tts.engine.mimi), cfg, SimpleCharTokenizer())
    text, seed = REQUESTS[0]
    before = trained.synthesize(text, ref=trained.prepare_reference(ref_tokens_tq=ref_tokens),
                                max_frames=MAX_FRAMES, seed=seed)

    # 20 steps at B = 8 on one batch
    opt = T.make_optimizer(model)
    step = T.make_train_step(model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    events, losses = [], []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step(batch)["loss"])
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    if any(kernels.LAUNCHES.values()):
        raise AssertionError(f"train: the steps launched a serving kernel: {kernels.LAUNCHES}")
    times = [s.elapsed_time(e) for s, e in events]
    losses = [float(x) for x in losses]
    ms = statistics.median(times[TRAIN_WARM:])
    frames = int(host_batch.frame_mask.sum())
    flops = PR.train_step_flops(cfg, b, TRAIN_S, l, tr)
    log(f"  {TRAIN_STEPS} steps at B = {b}, S = {TRAIN_S} ({frames} valid frames): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; {[round(x, 3) for x in losses]}")
    log(f"  step {ms:.3f} ms (CUDA events, median of steps {TRAIN_WARM + 1}-{TRAIN_STEPS}; "
        f"{min(times[TRAIN_WARM:]):.3f}-{max(times[TRAIN_WARM:]):.3f}), host wall {wall * 1e3:.3f} ms "
        f"per step; {frames / (ms / 1e3):.0f} valid frames/s; peak memory {peak / 2**30:.2f} GiB")
    log(f"  fwd+bwd {flops / 1e12:.4f} TFLOP per step (profiling.train_step_flops): "
        f"{flops / (ms / 1e3) / 1e12:.2f} TF/s = {flops / (ms / 1e3) / PEAK_FP32 * 100:.1f} % of the "
        f"fp32 peak; bound {flops / PEAK_FP32 * 1e3:.2f} ms")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    busy, launches, syncs, top, _ = profile_steps(step, batch)
    log(f"  profiler, 2 more steps: kernels busy {busy * 100:.1f} % of the host wall; "
        f"{launches:.0f} kernel launches and {syncs:.1f} synchronisations per step; largest kernels, "
        "ms per step: " + "; ".join(f"{k[:70]} {v:.3f}" for k, v in top))
    phases = step_phases(model, opt, batch)
    log("  one more step by phase, host ms to dispatch / ms between CUDA events: " + "; ".join(
        f"{k} {h:.2f} / {d:.2f}" for k, (h, d) in phases.items()))
    out.update(step_ms=ms, host_ms=wall * 1e3, frames_per_s=frames / (ms / 1e3),
               peak_gib=peak / 2**30, tflop=flops / 1e12, fp32_share=flops / (ms / 1e3) / PEAK_FP32,
               loss_first=losses[0], loss_last=losses[-1], kernels_busy=busy,
               launches_per_step=launches, syncs_per_step=syncs, phases=phases)

    with deterministic(), tempfile.TemporaryDirectory() as tmp:
        # the step through parallel/data.py at world size 1 on NCCL
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        P.init_process_group(0, 1, "file://" + os.path.join(tmp, "rendezvous"), device=dev)
        try:
            plain_m, dp_m = (W.sopro_params_from_jax(tree, cfg, dev) for _ in range(2))
            want = T.make_train_step(plain_m, T.make_optimizer(plain_m))(batch)
            got = P.make_train_step(dp_m, T.make_optimizer(dp_m))(P.shard_batch(batch, 0, 1))
            same_metrics(got, want, "parallel step at world size 1")
            same_state(dp_m, plain_m, "parallel step at world size 1")
            log(f"  parallel.make_train_step, NCCL world size 1: loss {float(got['loss']):.6f}, "
                "metrics and parameters equal to the plain step")
        finally:
            dist.destroy_process_group()
        del plain_m, dp_m

        # 2 steps, a checkpoint, a third step; restored into a fresh model, the same third step
        a = W.sopro_params_from_jax(tree, cfg, dev)
        opt_a = T.make_optimizer(a)
        step_a = T.make_train_step(a, opt_a)
        for _ in range(2):
            step_a(batch)
        path = os.path.join(tmp, "train.pt")
        t1 = time.perf_counter()
        T.save_train_checkpoint(path, a, opt_a, step=2)
        saved = {n: p.detach().cpu().clone() for n, p in a.named_parameters()}
        t2 = time.perf_counter()
        want = step_a(batch)
        fresh = W.sopro_params_from_jax(W.init_sopro_params(SEED + 13, cfg, 259), cfg, dev)
        opt_f = T.make_optimizer(fresh)
        t3 = time.perf_counter()
        if T.restore_train_checkpoint(path, fresh, opt_f) != 2:
            raise AssertionError("resume: the step number was not restored")
        t4 = time.perf_counter()
        same_metrics(T.make_train_step(fresh, opt_f)(batch), want, "resumed step 3")
        same_state(fresh, a, "resumed step 3")
        on_cpu = W.sopro_params_from_jax(W.init_sopro_params(SEED + 13, cfg, 259), cfg, "cpu")
        opt_c = T.make_optimizer(on_cpu)
        T.restore_train_checkpoint(path, on_cpu, opt_c, device="cpu")
        bad = [n for n, p in on_cpu.named_parameters() if not torch.equal(p.detach(), saved[n])]
        moments = [t for st in opt_c.state.values() for t in st.values() if torch.is_tensor(t)]
        if bad or any(t.device.type != "cpu" for t in moments):
            raise AssertionError(f"resume on the CPU: {len(bad)} parameters differ")
        log(f"  resume: checkpoint {os.path.getsize(path) / 1e6:.1f} MB written in {t2 - t1:.2f} s, "
            f"restored in {t4 - t3:.2f} s; step 3 after the restore equals 3 straight steps bit for "
            "bit; the card's checkpoint restores onto the CPU")
        del a, opt_a, fresh, opt_f, on_cpu, opt_c

    # serving from the trained model: its caches were built before the steps
    kernels.reset_launches()
    after = trained.synthesize(text, ref=trained.prepare_reference(ref_tokens_tq=ref_tokens),
                               max_frames=MAX_FRAMES, seed=seed)
    launched("trained synthesize", ("ar_loop", "nar_heads", "seanet"))
    with tempfile.TemporaryDirectory() as tmp:
        sdir, mdir = os.path.join(tmp, "sopro"), os.path.join(tmp, "mimi")
        trained.save_pretrained(sdir)
        write_mimi_snapshot(mdir, mcfg)
        loaded = SoproTTS.from_pretrained(sdir, mimi_repo_id=mdir, device=dev,
                                          tokenizer=SimpleCharTokenizer(), on_unconsumed="raise")
    want = loaded.synthesize(text, ref=loaded.prepare_reference(ref_tokens_tq=ref_tokens),
                             max_frames=MAX_FRAMES, seed=seed)
    if after.shape != want.shape or not np.array_equal(after, want):
        raise AssertionError("train: the trained model's synthesize differs from the reloaded model's")
    if before.shape == after.shape and np.array_equal(before, after):
        raise AssertionError("train: synthesize did not change with the weights")
    log(f"  trained synthesize: {after.shape[1]} samples, bit-identical to the model reloaded "
        "through save_pretrained / from_pretrained (and different from before the steps)")
    return out, tree, host_batch


# phase 15: the (dp, tp) training layout against the unsharded step, phase 11's model and batch
TP_WARM, TP_STEPS = 2, 6
TP_LOSS_RTOL = 2e-5
TP_GRAD_TOL = 1e-4  # of each leaf's largest |gradient|, plus 1e-6 of the largest of all leaves
# parameters after 2 AdamW steps (lr 3e-4): an element whose gradient is near 0 takes a step
# whose size its rounding sets, so at most TP_PARAM_SHARE of the elements may differ by more
# than TP_PARAM_TOL, and none by more than TP_PARAM_MAX
TP_PARAM_TOL, TP_PARAM_SHARE, TP_PARAM_MAX = 1e-6, 1e-4, 2e-4


def tp_layouts():
    """(name, mesh): tp = 2 with both shards on cuda:0 (a rehearsal: the
    shards take turns on one card), tp = 2 over 2 cards and (dp = 2, tp = 2)
    over 4 where they are present."""
    from sopro_tpu_torch.parallel import make_mesh

    dev0 = torch.device("cuda", 0)
    out = [("dp=1 tp=2 on cuda:0", make_mesh(2, dp=1, tp=2, devices=[dev0] * 2))]
    n = torch.cuda.device_count()
    if n >= 2:
        out.append(("dp=1 tp=2 over 2 cards", make_mesh(2, dp=1, tp=2)))
    if n >= 4:
        out.append(("dp=2 tp=2 over 4 cards", make_mesh(4, dp=2, tp=2)))
    return out


def params_close(state, model, dev, what):
    """Raise unless the state's gathered parameters are within the TP_PARAM
    tolerances of `model`'s; -> (largest difference, elements beyond TP_PARAM_TOL)."""
    full = state.full_leaves(dev)
    diff = torch.cat([(full[n] - p.detach()).abs().flatten() for n, p in model.named_parameters()])
    worst, over = float(diff.max()), int((diff > TP_PARAM_TOL).sum())
    if worst > TP_PARAM_MAX or over > TP_PARAM_SHARE * diff.numel():
        raise AssertionError(f"{what}: parameters differ by up to {worst:.3e}, {over} of "
                             f"{diff.numel()} elements beyond {TP_PARAM_TOL}")
    return worst, over


def close_metrics(got, want, what):
    rel = max(abs(float(got[k]) - float(want[k])) / abs(float(want[k])) for k in want)
    if not rel <= TP_LOSS_RTOL:
        raise AssertionError(f"{what}: metrics {({k: float(v) for k, v in got.items()})} vs "
                             f"{({k: float(v) for k, v in want.items()})}")
    return rel


def timed_steps(step, batch, devs):
    """TP_WARM + TP_STEPS steps -> (median ms between CUDA events on the
    first card over the timed steps, host wall ms per timed step)."""
    events = []
    for i in range(TP_WARM + TP_STEPS):
        if i == TP_WARM:
            for d in devs:
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(batch)
        end.record()
        events.append((start, end))
    for d in devs:
        torch.cuda.synchronize(d)
    wall = (time.perf_counter() - t0) / TP_STEPS * 1e3
    return statistics.median(s.elapsed_time(e) for s, e in events[TP_WARM:]), wall


def drive_tp(tree, host_batch, cfg, unsharded):
    """Phase 15: per layout of `tp_layouts`, the sharded loss and gradients
    against the unsharded ones on the same weights and batch, 2 steps of
    each, a checkpoint of the sharded state restored onto an unsharded
    model and a third step of both, then step ms, frames/s and peak memory
    per card beside the unsharded step's."""
    from sopro_tpu_torch import kernels
    from sopro_tpu_torch import train as T
    from sopro_tpu_torch import weights as W
    from sopro_tpu_torch.parallel import tensor as TP

    frames = int(host_batch.frame_mask.sum())
    out = {}
    for name, mesh in tp_layouts():
        dev0 = mesh.devices[0, 0]
        devs = sorted(set(mesh.devices.flat), key=str)
        batch = host_batch.to(dev0)
        kernels.reset_launches()
        model = W.sopro_params_from_jax(tree, cfg, dev0)
        state, opt = TP.shard_train_state(mesh, model, T.make_optimizer(model))
        del model
        plain = W.sopro_params_from_jax(tree, cfg, dev0)
        plain_opt = T.make_optimizer(plain)
        whole = sum(lay.dim is not None for lay in state.layouts)
        where = sorted({str(p.device) for p in state.parameters()})
        log(f"  {name}: {whole} of {len(state.layouts)} leaves split over tp, masters on {where}")

        # the loss and every leaf's gradient against the unsharded ones
        got = []
        for o, f in ((plain_opt, lambda: T.loss_fn(plain, batch)), (opt, lambda: TP.loss_fn(state, batch))):
            o.zero_grad(set_to_none=False)
            loss, metrics = f()
            loss.backward()
            T.fill_missing_grads(o)
            got.append({k: v.detach() for k, v in metrics.items()})
        loss_rel = close_metrics(got[1], got[0], f"{name}: loss")
        want = {n: p.grad for n, p in plain.named_parameters()}
        gmax = max(float(g.abs().max()) for g in want.values())
        ratio, leaf = max(
            (float((lay.join([p.grad.to(dev0) for p in state.leaves[lay.path]])
                    - want[lay.name]).abs().max())
             / (TP_GRAD_TOL * float(want[lay.name].abs().max()) + 1e-6 * gmax), lay.name)
            for lay in state.layouts)
        if not ratio <= 1.0:
            raise AssertionError(f"{name}: leaf {leaf}'s gradient at {ratio:.3f} of its tolerance")
        log(f"  {name}: loss {float(got[1]['loss']):.6f}, rel err {loss_rel:.2e} (tol {TP_LOSS_RTOL}); "
            f"worst leaf {leaf}: gradient error {ratio:.4f} of its tolerance")

        # 2 steps of each, then a checkpoint restored onto an unsharded model, and a third step
        step, plain_step = TP.make_train_step(state, opt), T.make_train_step(plain, plain_opt)
        for i in range(2):
            close_metrics(step(batch), plain_step(batch), f"{name}: step {i + 1}")
        worst, over = params_close(state, plain, dev0, f"{name}: 2 steps")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "train.pt")
            T.save_train_checkpoint(path, state, opt, step=2)
            resumed = W.sopro_params_from_jax(tree, cfg, dev0)
            resumed_opt = T.make_optimizer(resumed)
            if T.restore_train_checkpoint(path, resumed, resumed_opt) != 2:
                raise AssertionError(f"{name}: the step number was not restored")
        saved = state.train_state_dict(opt)
        same = all(torch.equal(p.detach().cpu(), saved["model"][n]) for n, p in resumed.named_parameters())
        rstate = resumed_opt.state_dict()["state"]
        same_m = all(torch.equal(rstate[i][k].cpu(), v) for i, st in saved["optimizer"]["state"].items()
                     for k, v in st.items())
        if not (same and same_m):
            raise AssertionError(f"{name}: the unsharded restore differs (params {same}, moments {same_m})")
        close_metrics(step(batch), T.make_train_step(resumed, resumed_opt)(batch), f"{name}: step 3")
        worst3, over3 = params_close(state, resumed, dev0, f"{name}: step 3 after the restore")
        log(f"  {name}: 2 steps: parameters within {worst:.3e} ({over} elements beyond "
            f"{TP_PARAM_TOL}); saved, restored onto an unsharded model bit for bit (parameters and "
            f"moments), its step 3 within {worst3:.3e} ({over3} beyond) of the sharded step 3")
        del resumed, resumed_opt, saved

        # timing: the sharded and the unsharded step in turns on the same batch
        for d in devs:
            torch.cuda.reset_peak_memory_stats(d)
        # what stays allocated between steps: both models' parameters, gradients and moments
        held = {str(d): torch.cuda.memory_allocated(d) / 2**30 for d in devs}
        ms, wall = timed_steps(step, batch, devs)
        peaks = {str(d): torch.cuda.max_memory_allocated(d) / 2**30 for d in devs}
        torch.cuda.reset_peak_memory_stats(dev0)
        plain_ms, plain_wall = timed_steps(plain_step, batch, [dev0])
        plain_peak = torch.cuda.max_memory_allocated(dev0) / 2**30
        if any(kernels.LAUNCHES.values()):
            raise AssertionError(f"{name}: the tp steps launched a serving kernel: {kernels.LAUNCHES}")
        row = dict(step_ms=ms, host_ms=wall, frames_per_s=frames / (ms / 1e3), peak_gib=peaks, held_gib=held,
                   plain_step_ms=plain_ms, plain_host_ms=plain_wall, plain_peak_gib=plain_peak,
                   loss_rel_err=loss_rel, grad_err_of_tol=ratio, param_err_2=worst, param_over_2=over,
                   param_err_3=worst3)
        if len(devs) == 1:
            busy, launches, syncs, top, _ = profile_steps(step, batch)
            row.update(kernels_busy=busy, launches_per_step=launches, syncs_per_step=syncs)
            log(f"  {name}: profiler, 2 steps: kernels busy {busy * 100:.1f} %, {launches:.0f} "
                f"launches and {syncs:.1f} synchronisations per step")
        log(f"  {name}: step {ms:.3f} ms (CUDA events on cuda:0, median of {TP_STEPS} after "
            f"{TP_WARM} warm), host wall {wall:.3f} ms; {frames / (ms / 1e3):.0f} valid frames/s; "
            "peak memory " + ", ".join(f"{k} {v:.2f} GiB" for k, v in peaks.items()) + " (held "
            "between steps, both models with their gradients and moments: "
            + ", ".join(f"{k} {v:.2f}" for k, v in held.items()) + ")")
        log(f"  {name}: the unsharded step in the same turn {plain_ms:.3f} ms (host {plain_wall:.3f}), "
            f"peak {plain_peak:.2f} GiB; phase 11's {unsharded['step_ms']:.3f} ms, "
            f"{unsharded['peak_gib']:.2f} GiB")
        out[name] = row
        del state, opt, plain, plain_opt, step, plain_step
        torch.cuda.empty_cache()
    return out


def read_wav16(path):
    import wave

    with wave.open(path, "rb") as f:
        if (f.getframerate(), f.getnchannels(), f.getsampwidth()) != (24000, 1, 2):
            raise AssertionError(f"{path}: not 24 kHz mono PCM16")
        return np.frombuffer(f.readframes(f.getnframes()), np.int16)


CLI_LONG_TEXT = PARAGRAPH + " " + PARAGRAPH  # over 350 characters: two rows of one batch


def drive_cli(tts, ref, ref_tokens):
    """Phase 12: the CLI in subprocesses against phase 4's model in this
    process (`--seed` seeds both the random weights and the sampling, so
    every run takes phase 4's SEED)."""
    from sopro_tpu_torch import audio as A
    from sopro_tpu_torch.profiling import TRACE_FILE

    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "ref.npy")
        np.save(ref_path, ref_tokens)

        def cli(name, text, *extra):
            path = os.path.join(tmp, f"{name}.wav")
            cmd = [sys.executable, "-m", "sopro_tpu_torch.cli", "--random_init", "--device", "cuda",
                   "--seed", str(SEED), "--ref_tokens", ref_path, "--max_frames", str(MAX_FRAMES),
                   "--metrics_json", "--text", text, "--out", path, *extra]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise AssertionError(f"cli {name}: exit {r.returncode}\n{r.stderr[-3000:]}")
            metrics = json.loads(r.stdout.strip().splitlines()[-1])
            log(f"  cli {name}: exit 0 in {time.perf_counter() - t0:.2f} s; metrics {metrics}")
            return read_wav16(path), metrics

        def same(got, want, what):
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"cli {what}: the WAV differs from the library's")
            log(f"  cli {what}: {got.size} samples (peak {int(np.abs(got).max(initial=0))} LSB), "
                "equal to the library's")

        text = REQUESTS[1][0]
        trace = os.path.join(tmp, "trace")
        wav, out["metrics"] = cli("synthesize", text, "--trace_dir", trace)
        same(wav, tts.synthesize(text, ref=ref, max_frames=MAX_FRAMES, seed=SEED, pcm16=True)[0],
             "synthesize")
        with open(os.path.join(trace, TRACE_FILE)) as f:
            kernels = [e.get("name", "") for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
        counts = {k: sum(1 for n in kernels if any(s in n for s in subs)) for k, subs in
                  (("ar_loop", ("ar_loop_kernel",)), ("nar_heads", ("nar_heads_kernel",)),
                   ("seanet", ("conv_wgmma_kernel", "resblock_wgmma_kernel")))}
        log(f"  cli trace: {len(kernels)} kernel events; K1 / K2 / K3 launches named in it: {counts}")
        if not all(counts.values()):
            raise AssertionError(f"cli trace: a kernel is missing: {counts}")
        out["trace_kernels"] = counts

        text = STREAM_REQUESTS[0][0]
        wav, _ = cli("stream", text, "--stream")
        chunks = tts.stream(text, ref=ref, max_frames=MAX_FRAMES, seed=SEED, chunk_frames=CHUNK)
        same(wav, A.pcm16(np.concatenate(list(chunks), axis=1))[0], "--stream")

        wav, _ = cli("long", CLI_LONG_TEXT, "--long")
        same(wav, tts.synthesize_long(CLI_LONG_TEXT, ref=ref, max_frames=MAX_FRAMES, seed=SEED,
                                      pcm16=True)[0], "--long")
    return out


# phase 13: the bfloat16 compute policy
BF16_TOL = 1e-2  # a bf16 kernel against its bf16 plain version, of the peak (a few bf16 steps)
BF16_NAR_GAP = 1e-4  # K2 bf16: ids equal wherever the float64 top-2 margin exceeds this
BF16_SERVE_MAX = 96  # the bf16 burst's max_frames
TPU_BF16_SNR_DB = 41.0  # bench.py's comment: the JAX package's bf16 vocoder SNR on a TPU


def launched_bf16(path: str, needed):
    """The bf16 launch counts since the last reset; raises unless every
    kernel in `needed` launched its bfloat16 instantiation and no float32
    instantiation launched."""
    from sopro_tpu_torch import kernels

    bf16, f32 = dict(kernels.LAUNCHES_BF16), dict(kernels.LAUNCHES)
    log(f"  bf16 launches during the {path} run: {bf16} (float32: {f32})")
    missing = [k for k in needed if bf16[k] <= 0]
    if missing or any(f32.values()):
        raise AssertionError(f"the bf16 {path} path: bf16 kernels {missing} not launched, "
                             f"float32 launches {f32}")
    return bf16


class RecordingContext:
    """An AR context whose plain steps keep their logits [B, V]
    (`ar_loop_step` reads cfg, emb and step)."""

    def __init__(self, ctx):
        self.ctx, self.cfg, self.emb, self.logits = ctx, ctx.cfg, ctx.emb, []

    def step(self, x, bufs):
        logits, bufs = self.ctx.step(x, bufs)
        self.logits.append(logits.float())
        return logits, bufs


def first_divergence(got, want, logits, row, what, tol=BF16_TOL):
    """The first step where row `row` of the kernel's tokens `got` leaves
    the plain run's `want` (-1: none). Raises unless the plain run's
    penalized top-2 margin there is within tol of its peak logit (a near-tie
    that bf16 rounding can tip); the history starts empty."""
    from sopro_tpu_torch.ops.ar_loop import REP_PENALTY

    diff = (got[row] != want[row]).nonzero()
    if len(diff) == 0:
        return -1
    i = int(diff[0])
    x = logits[i][row].double().clone()
    for t in set(int(v) for v in want[row, max(0, i - 50):i].tolist()):
        x[t] = x[t] * REP_PENALTY if x[t] < 0 else x[t] / REP_PENALTY
    top2 = torch.topk(x, 2).values
    margin = float(top2[0] - top2[1]) / float(logits[i][row].abs().max())
    log(f"  {what}: row {row} leaves the plain tokens at step {i}, penalized top-2 margin "
        f"{margin:.2e} of the peak logit")
    if margin > tol:
        raise AssertionError(f"{what}: row {row} diverges at step {i} with a margin of {margin:.2e}")
    return i


def check_bf16_kernels(tts16, dev, rng):
    """Each bfloat16 kernel against its bfloat16 plain version on the card at
    the main paths' shapes, timed beside the plain version and the bf16
    library yardstick; bounds at 2 bytes an element and the 989 TFLOP/s
    bfloat16 tensor-core rate (`design_bound_ms`: at the rate of the design
    taken, the bfloat16 tensor cores for K2, K3 and K4, the fp32 cores for
    K1 and K5)."""
    from sopro_tpu_torch import kernels
    from sopro_tpu_torch.bench_kernels import (
        ar_cost, bound, conv_stack_cost, nar_cost, nar_library, seanet_library,
        seanet_library_weights,
    )
    from sopro_tpu_torch.codec.mimi import decode_embeddings, seanet_apply
    from sopro_tpu_torch.codec.mimi_config import decoder_plan, required_halo
    from sopro_tpu_torch.codec.vocoder import (
        seanet_decode, seanet_decode_chunk, seanet_decode_chunk_plain,
    )
    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.ops.ar_loop import ar_loop, ar_loop_plain
    from sopro_tpu_torch.ops.ar_step import ar_step, ar_step_plain
    from sopro_tpu_torch.ops.nar_heads import nar_heads_argmax, nar_heads_argmax_plain
    from sopro_tpu_torch.tokenizer import SimpleCharTokenizer

    bf16 = torch.bfloat16
    model, mimi, eng, cfg = tts16.engine.model, tts16.engine.mimi, tts16.engine, tts16.cfg
    mcfg, plan = mimi.cfg, decoder_plan(mimi.cfg)
    stats = {}

    # K2 at NAR_ROWS rows per stage
    out = {"max_abs_err": 0.0, "mismatches": 0}
    with torch.inference_mode():
        for rows in NAR_ROWS:
            ms = plain_ms = lib_ms = flop = nbytes = 0.0
            for stage, (hid, w, b, packed) in model.nar.head_stacks().items():
                z = torch.from_numpy(rng.standard_normal((1, rows, w.shape[1])).astype(np.float32))
                z = z.to(dev, bf16)
                got, want = nar_heads_argmax(z, hid, w, b, packed), nar_heads_argmax_plain(z, hid, w, b)
                zh = (z[:, :, None] + hid[None, None]).double()
                logits = torch.einsum("bthd,hdv->bthv", zh, w.double()) + b.double()[None, None]
                top2 = torch.topk(logits, 2, dim=-1).values
                differ = got != want
                if bool((differ & (top2[..., 0] - top2[..., 1] > BF16_NAR_GAP)).any()):
                    raise AssertionError(f"nar_heads bf16 {rows} rows stage {stage}: ids differ at a "
                                         "clear margin")
                out["mismatches"] += int(differ.sum())
                gl = torch.gather(logits, -1, got.long()[..., None])[..., 0]
                out["max_abs_err"] = max(out["max_abs_err"], float((top2[..., 0] - gl).max()))
                ms += cuda_ms(lambda: nar_heads_argmax(z, hid, w, b, packed), 20)
                plain_ms += cuda_ms(lambda: nar_heads_argmax_plain(z, hid, w, b), 20)
                lib_ms += cuda_ms(lambda: nar_library(z, hid, w, b), 20)
                f, n = nar_cost(rows, *w.shape, es=2)
                flop, nbytes = flop + f, nbytes + n
            bnd = bound(flop, nbytes, tf32x3=True, bf16=True)
            log(f"  bf16 nar_heads {rows} rows, 4 stages: {ms:.3f} ms (kernel) vs {plain_ms:.3f} ms "
                f"(plain), {lib_ms:.3f} ms (bf16 einsum + argmax); bound {bnd['bound_ms']:.4f} ms "
                f"({bnd['bound_rate']}), design bound {bnd['design_bound_ms']:.4f} ms")
            out[rows] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bnd)
    log(f"  bf16 nar_heads: ids differ only at near-ties ({out['mismatches']} positions); worst "
        f"float64 logit gap of a chosen id {out['max_abs_err']:.3e}")
    stats["nar_heads"] = dict(out[MAX_FRAMES + 1], max_abs_err=out["max_abs_err"],
                              by_rows={r: out[r] for r in NAR_ROWS})

    # K3 at B = 1 and 4
    lib_w = seanet_library_weights(mimi.p["decoder"], plan)
    packed = mimi.packed_decoder()
    k3 = {}
    with torch.inference_mode():
        for b in (1, 4):
            codes = torch.from_numpy(
                rng.integers(0, mcfg.codebook_size, (b, MAX_FRAMES + 1, mcfg.num_quantizers))).to(dev)
            emb = decode_embeddings(mimi.p, mcfg, codes).contiguous()
            got, want = seanet_decode(packed, mcfg, emb), seanet_apply(mimi.p["decoder"], plan, emb)[..., 0]
            if got.dtype != bf16 or got.shape != want.shape:
                raise AssertionError(f"seanet bf16 B={b}: {got.dtype} {tuple(got.shape)}")
            err, peak = float((got.float() - want.float()).abs().max()), float(want.float().abs().max())
            if not err <= BF16_TOL * peak:
                raise AssertionError(f"seanet bf16 B={b}: max|err| {err} > {BF16_TOL} * peak {peak}")
            row = dict(max_abs_err=err, peak=peak, ms=cuda_ms(lambda: seanet_decode(packed, mcfg, emb), 5),
                       plain_ms=cuda_ms(lambda: seanet_apply(mimi.p["decoder"], plan, emb), 5),
                       library_ms=cuda_ms(lambda: seanet_library(lib_w, emb), 5),
                       **bound(*conv_stack_cost(packed["ops"], b, emb.shape[1], causal=True),
                               tf32x3=True, bf16=True))
            log(f"  bf16 seanet B={b}: max|err| {err:.3e} of peak {peak:.3e}; {row['ms']:.3f} ms "
                f"(kernel) vs {row['plain_ms']:.3f} ms (plain), {row['library_ms']:.3f} ms (cuDNN "
                f"bf16 stack); bound {row['bound_ms']:.4f} ms ({row['bound_rate']}), design bound "
                f"{row['design_bound_ms']:.4f} ms")
            k3[b] = row
    stats["seanet"] = dict(k3[1], B4=k3[4])

    # K4 at chunks 6 and 16, and 8 serving rows with partial histories
    halo, hop25 = required_halo(mcfg), int(np.prod(mcfg.upsampling_ratios))
    k4 = {}
    with torch.inference_mode():
        for b, m25, hist in ((1, 2 * CHUNK, None), (1, 32, None), SERVE_K4):
            frames = -(-(halo + m25) // 2)
            codes = torch.from_numpy(
                rng.integers(0, mcfg.codebook_size, (b, frames, mcfg.num_quantizers))).to(dev)
            ext = decode_embeddings(mimi.p, mcfg, codes)[:, -(halo + m25):].contiguous()
            n_hist = None if hist is None else torch.tensor(hist, dtype=torch.int32, device=dev)
            got = seanet_decode_chunk(packed, mcfg, ext, n_hist)
            want = seanet_decode_chunk_plain(mimi.p["decoder"], mcfg, ext, n_hist)
            what = f"bf16 seanet_chunk B={b} ext {tuple(ext.shape)} n_hist={hist or halo}"
            if not torch.equal(got, seanet_decode_chunk(packed, mcfg, ext, n_hist)):
                raise AssertionError(f"{what}: a repeated call is not bit-identical")
            err, peak = float((got.float() - want.float()).abs().max()), float(want.float().abs().max())
            if got.shape != (b, m25 * hop25) or not err <= BF16_TOL * peak:
                raise AssertionError(f"{what}: {tuple(got.shape)}, max|err| {err} vs peak {peak}")
            row = dict(max_abs_err=err, ms=cuda_ms(lambda: seanet_decode_chunk(packed, mcfg, ext, n_hist), 20),
                       plain_ms=cuda_ms(lambda: seanet_decode_chunk_plain(mimi.p["decoder"], mcfg, ext,
                                                                          n_hist), 20),
                       library_ms=None)
            if hist is None:
                n_out = m25 * hop25
                row["library_ms"] = cuda_ms(lambda: seanet_library(lib_w, ext)[:, -n_out:], 20)
                row.update(bound(*conv_stack_cost(packed["ops"], b, ext.shape[1], causal=False,
                                                  keep=n_out), tf32x3=True, bf16=True))
            log(f"  {what}: max|err| {err:.3e} of peak {peak:.3e}, repeat bit-identical; "
                f"{row['ms']:.3f} ms (kernel) vs {row['plain_ms']:.3f} ms (plain)"
                + (f", {row['library_ms']:.3f} ms (cuDNN bf16), bound {row['bound_ms']:.4f} ms "
                   f"({row['bound_rate']}), design bound {row['design_bound_ms']:.4f} ms"
                   if hist is None else ""))
            k4[(b, m25, hist)] = row
    stats["seanet_chunk"] = dict(k4[(1, 2 * CHUNK, None)], chunk16=k4[(1, 32, None)],
                                 serve_b8=k4[SERVE_K4],
                                 max_abs_err=max(r["max_abs_err"] for r in k4.values()))

    # K1: 401 near-greedy steps against the plain loop; B = 1, 4, 7, 8 rows
    ids = np.asarray(SimpleCharTokenizer().encode(REQUESTS[0][0]), np.int32)
    ref = eng.prepare_reference(rng.integers(0, cfg.codebook_size, (150, cfg.num_codebooks)
                                             ).astype(np.int32))
    s = MAX_FRAMES + 1
    keys = ("t", "last", "streak", "stopped", "first_eos", "key", "hist", "bufs")
    with torch.inference_mode():
        prep = eng.prepare_conditioning(ids, ref, max_frames=MAX_FRAMES, style_strength=1.0)
        cond = prep["cond_ar"]
        ctx = M.ar_context(model, prep["txt_seq"], prep["text_mask"])

        def fresh(b=1, c=cond):
            carry = M.init_ar_carry(cfg, b, c.shape[1], 7, dev, bf16)
            return {k: getattr(carry, k) for k in keys}

        greedy = M.ARSettings(temperature=1e-4, anti_loop=False).per_row(1, dev)
        tk, sk = ar_loop(ctx, cond, fresh(), greedy, s, False)
        rec = RecordingContext(ctx)
        tp, sp = ar_loop_plain(rec, cond, fresh(), greedy, s, False)
        torch.cuda.synchronize()
        first = first_divergence(tk, tp, rec.logits, 0, "bf16 ar_loop near-greedy")
        k1 = {"first_diff": first, "steps": int(sk["t"][0])}
        if first >= 0:  # a near-tie parted the tokens: hold the state after the equal steps
            tk, sk = ar_loop(ctx, cond, fresh(), greedy, first, False)
            tp, sp = ar_loop_plain(ctx, cond, fresh(), greedy, first, False)
            torch.cuda.synchronize()
            if not torch.equal(tk, tp):
                raise AssertionError(f"bf16 ar_loop: the first {first} tokens differ on a rerun")
        for k in ("t", "last", "streak", "stopped", "first_eos", "key", "hist"):
            if not torch.equal(sk[k], sp[k]):
                raise AssertionError(f"bf16 ar_loop: the same tokens but another state {k}")
        err, peak = (float((sk["bufs"].float() - sp["bufs"].float()).abs().max()),
                     float(sp["bufs"].float().abs().max()))
        if not err <= BF16_TOL * peak:
            raise AssertionError(f"bf16 ar_loop: conv state max|err| {err} > {BF16_TOL} * {peak}")
        k1["max_abs_err"], n_eq = err, int(sp["t"][0])
        if n_eq < cond.shape[1]:  # the next step's logits from each state, through the same plain step
            prev = sp["last"] if n_eq > 0 else torch.full_like(sp["last"], cfg.ar_vocab)
            x = cond[:, n_eq] + ctx.emb[prev.long()]
            lk, lp = ctx.step(x, sk["bufs"])[0], ctx.step(x, sp["bufs"])[0]
            lerr, lpeak = float((lk - lp).abs().max()), float(lp.abs().max())
            if not lerr <= BF16_TOL * lpeak:
                raise AssertionError(f"bf16 ar_loop: step {n_eq} logits from the kernel's state "
                                     f"max|err| {lerr} > {BF16_TOL} * {lpeak}")
            k1["state_logit_err"] = lerr
            log(f"  bf16 ar_loop near-greedy: {n_eq} equal steps, conv-state max|err| {err:.3e} of "
                f"peak {peak:.3e}; step {n_eq} logits from the kernel's state max|err| {lerr:.3e} "
                f"of peak {lpeak:.3e}")
        else:
            log(f"  bf16 ar_loop near-greedy: {n_eq} equal steps, conv-state max|err| {err:.3e} of "
                f"peak {peak:.3e}")
        prod = M.ARSettings().per_row(1, dev)
        k1["ms"] = cuda_ms(lambda: ar_loop(ctx, cond, fresh(), prod, s, True), 3)
        k1["plain_ms"] = cuda_ms(lambda: ar_loop_plain(ctx, cond, fresh(), prod, s, True), 1)
        _, st = ar_loop(ctx, cond, fresh(), prod, s, True)
        k1["steps"] = int(st["t"][0])
        k1["us_per_step"] = k1["ms"] * 1e3 / k1["steps"]
        kv_k = torch.stack([c["k"] for c in ctx.kv if c is not None])
        k1.update(bound(*ar_cost(model.ar.stacked(), kv_k, k1["steps"], 1), tf32x3=False, bf16=True),
                  library_ms=None)
        log(f"  bf16 ar_loop: {k1['steps']} steps {k1['ms']:.3f} ms (kernel, "
            f"{k1['us_per_step']:.1f} µs per step) vs {k1['plain_ms']:.3f} ms (plain); bound "
            f"{k1['bound_ms']:.4f} ms ({k1['bound_rate']}), design bound {k1['design_bound_ms']:.4f} ms")
        rows, texts = {}, [REQUESTS[i % 3][0] for i in range(max(K1_ROWS))]
        for b in K1_ROWS:
            pad_ids, mask = eng._padded([np.asarray(SimpleCharTokenizer().encode(t), np.int32)
                                         for t in texts[:b]], eng.rt.text_buckets)
            pb = M.prepare_conditioning(model, pad_ids, mask, M.tile_reference(ref, b),
                                        max_frames=MAX_FRAMES, style_strength=1.0)
            cb, ctx_b = pb["cond_ar"], M.ar_context(model, pb["txt_seq"], mask)
            per_row = M.ARSettings().per_row(b, dev)
            ms = cuda_ms(lambda: ar_loop(ctx_b, cb, fresh(b, cb), per_row, 64, True), 5)
            rows[b] = {"us_per_step": ms * 1e3 / 64, "launch": kernels.LAUNCH_INFO["ar_loop"]}
            near = M.ARSettings(temperature=torch.tensor([1e-4 * (1 + i) for i in range(b)]),
                                anti_loop=False,
                                min_gen_frames=torch.tensor([1 + 7 * i for i in range(b)]))
            near = near.per_row(b, dev)
            tk_b, _ = ar_loop(ctx_b, cb, fresh(b, cb), near, 64, False)
            rec_b = RecordingContext(ctx_b)
            tp_b, _ = ar_loop_plain(rec_b, cb, fresh(b, cb), near, 64, False)
            torch.cuda.synchronize()
            rows[b]["first_diff"] = [first_divergence(tk_b, tp_b, rec_b.logits, r,
                                                      f"bf16 ar_loop B={b}") for r in range(b)]
            log(f"  bf16 K1 at B={b}: {rows[b]['us_per_step']:.1f} µs per step over 64 steps, "
                f"{rows[b]['launch']['row_groups']} group(s), {rows[b]['launch']['waves']} wave; "
                f"near-greedy rows against the plain loop, first divergence per row "
                f"{rows[b]['first_diff']} (-1: none)")
        k1["serve_rows"] = rows
    stats["ar_loop"] = k1

    # K5 at B = 1 and 2, text bucket 64
    worst = 0.0
    k5 = {}
    with torch.inference_mode():
        for b in (1, 2):
            pad_ids, mask = eng._padded([np.asarray(SimpleCharTokenizer().encode(t), np.int32)
                                         for t in (REQUESTS[0][0], "Short one")[:b]],
                                        eng.rt.text_buckets)
            pb = M.prepare_conditioning(model, pad_ids, mask, M.tile_reference(ref, b),
                                        max_frames=MAX_FRAMES, style_strength=1.0)
            sctx = M.ar_step_context(model, pb["txt_seq"], mask)
            x = (pb["cond_ar"][:, 0] + sctx.emb[-1]).contiguous()
            bufs = (torch.from_numpy(rng.standard_normal(
                (cfg.n_layers_ar, b, fresh()["bufs"].shape[2], cfg.d_model)).astype(np.float32))
                * 0.3).to(dev, bf16)
            (lg, bg), (lw, bw) = ar_step(sctx, x, bufs), ar_step_plain(sctx, x, bufs)
            torch.cuda.synchronize()
            for name, g, w in (("logits", lg, lw), ("bufs", bg, bw)):
                err, peak = float((g.float() - w.float()).abs().max()), float(w.float().abs().max())
                log(f"  bf16 ar_step B={b} {name}: max|err| {err:.3e}, peak {peak:.3e}")
                if not err <= BF16_TOL * peak:
                    raise AssertionError(f"bf16 ar_step B={b}: {name} max|err| {err} vs peak {peak}")
                worst = max(worst, err) if name == "logits" else worst
            if b == 1:
                k5["ms"] = cuda_ms(lambda: ar_step(sctx, x, bufs), 50)
                k5["plain_ms"] = cuda_ms(lambda: ar_step_plain(sctx, x, bufs), 20)
                k5.update(bound(*ar_cost(model.ar.stacked(), sctx.kv_k, 1, 1), tf32x3=False, bf16=True))
    k5.update(max_abs_err=worst, library_ms=None)
    log(f"  bf16 ar_step (B = 1): {k5['ms'] * 1e3:.1f} µs (kernel) vs {k5['plain_ms'] * 1e3:.1f} µs "
        f"(plain); bound {k5['bound_ms'] * 1e3:.2f} µs ({k5['bound_rate']}), design bound "
        f"{k5['design_bound_ms'] * 1e3:.2f} µs")
    stats["ar_step"] = k5
    return stats


def drive_bf16(cfg, mcfg, dev, rng, ref_tokens, tts32, ref32):
    """Phase 13: the bf16 compute policy on the card. The kernels against
    their plain versions, then the paths with counters zeroed before and
    read after each: three 400-frame synthesize requests, three streams at
    chunk 6, a B = 4 batch, the per-step route, an 8-way batcher burst; and
    the bf16 Mimi decode against the fp32 one on the fp32 path's codes."""
    from sopro_tpu_torch import kernels
    from sopro_tpu_torch.config import RuntimeConfig
    from sopro_tpu_torch.serve import ContinuousBatcher
    from sopro_tpu_torch.tts import SoproTTS

    rt = RuntimeConfig(compute_dtype="bfloat16")
    t0 = time.perf_counter()
    tts = SoproTTS.from_random(cfg, seed=SEED, mimi_cfg=mcfg, device=dev, runtime=rt)
    log(f"  from_random(runtime=bfloat16): {time.perf_counter() - t0:.2f} s; parameters "
        f"{next(tts.engine.model.parameters()).dtype}")
    stats = check_bf16_kernels(tts, dev, rng)
    hop, sr = tts.engine.mimi_cfg.hop_length, float(mcfg.sampling_rate)
    ref = tts.prepare_reference(ref_tokens_tq=ref_tokens)
    tts.synthesize("warm up", ref=ref, max_frames=8, seed=0)
    torch.cuda.synchronize()
    out = {}

    kernels.reset_launches()
    secs = []
    for text, seed in REQUESTS:
        t1 = time.perf_counter()
        wav = tts.synthesize(text, ref=ref, max_frames=MAX_FRAMES, seed=seed)
        sec = time.perf_counter() - t1
        if wav.dtype != np.float32 or wav.shape[1] % hop or not np.isfinite(wav).all():
            raise AssertionError(f"bf16 synthesize: {wav.dtype} {wav.shape}")
        audio_s = wav.shape[1] / sr
        secs.append(sec)
        log(f"  bf16 request seed={seed}: {wav.shape[1] // hop} frames, {audio_s:.2f} s audio in "
            f"{sec:.3f} s, RTF {sec / audio_s:.4f}")
    out["synthesize"] = launched_bf16("synthesize", ("ar_loop", "nar_heads", "seanet"))
    out["request_s"] = secs

    run_stream(tts, "warm up", ref, 0)
    torch.cuda.synchronize()
    kernels.reset_launches()
    runs = [(text, seed, *run_stream(tts, text, ref, seed)) for text, seed in STREAM_REQUESTS]
    out["stream"] = launched_bf16("stream", ("ar_loop", "nar_heads", "seanet_chunk"))
    out["ttfa_ms"], out["chunk_ms"] = [], []
    for text, seed, chunks, ttfa, gaps in runs:
        frames = check_stream(chunks, tts, text, ref, seed, f"bf16 stream seed={seed}")
        out["ttfa_ms"].append(ttfa * 1e3)
        out["chunk_ms"].append(statistics.mean(gaps) * 1e3)
        log(f"  bf16 stream seed={seed}: {frames} frames in {len(chunks)} chunks; TTFA "
            f"{ttfa * 1e3:.2f} ms; steady chunk mean {statistics.mean(gaps) * 1e3:.2f} ms")

    texts, seeds = BATCH
    tts.synthesize_batch(texts, ref=ref, max_frames=8, seeds=seeds)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t1 = time.perf_counter()
    outs = tts.synthesize_batch(texts, ref=ref, max_frames=MAX_FRAMES, seeds=seeds)
    sec = time.perf_counter() - t1
    launched_bf16("batch", ("ar_loop", "nar_heads", "seanet"))
    if not np.array_equal(outs[0], outs[3]) or not all(np.isfinite(o).all() for o in outs):
        raise AssertionError("bf16 synthesize_batch: duplicated rows differ or samples not finite")
    audio_s = sum(o.shape[1] for o in outs) / sr
    out["batch_s"] = sec
    log(f"  bf16 synthesize_batch B={len(texts)}: {[o.shape[1] // hop for o in outs]} frames, "
        f"{audio_s:.2f} s audio in {sec:.3f} s, RTF {sec / audio_s:.4f}")

    step_rt = RuntimeConfig(compute_dtype="bfloat16", use_pallas_resident=False)
    step = SoproTTS.from_random(cfg, seed=SEED, mimi_cfg=mcfg, device=dev, runtime=step_rt)
    sref = step.prepare_reference(ref_tokens_tq=ref_tokens)
    step.synthesize("warm up", ref=sref, max_frames=8, seed=0)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t1 = time.perf_counter()
    wav = step.synthesize(REQUESTS[0][0], ref=sref, max_frames=MAX_FRAMES, seed=REQUESTS[0][1])
    step_s = time.perf_counter() - t1
    text, seed = STREAM_REQUESTS[0]
    chunks, _, _ = run_stream(step, text, sref, seed)
    out["per_step"] = launched_bf16("per-step route", ("ar_step", "nar_heads", "seanet",
                                                       "seanet_chunk"))
    if out["per_step"]["ar_loop"]:
        raise AssertionError("the bf16 per-step route launched K1")
    check_stream(chunks, step, text, sref, seed, "bf16 per-step stream")
    log(f"  bf16 per-step route: synthesize {wav.shape[1] // hop} frames in {step_s:.3f} s "
        f"(K5 launched, K1 not), a stream of {len(chunks)} chunks")
    del step

    b = ContinuousBatcher(tts, slots=8, chunk_frames=16, ramp_frames=4, text_bucket=SERVE_TEXT_BUCKET,
                          max_frames=BF16_SERVE_MAX)
    try:
        b.warmup()
        kernels.reset_launches()
        t1 = time.perf_counter()
        hs = [b.submit(SERVE_TEXTS[i], ref, seed=SERVE_SEEDS[i]) for i in range(8)]
        outs = [list(h.chunks()) for h in hs]
        wall = time.perf_counter() - t1
    finally:
        b.stop()
    out["serve"] = launched_bf16("serve", ("ar_loop", "nar_heads", "seanet_chunk"))
    audio = 0
    for i, chunks in enumerate(outs):
        frames = sum(c.shape[1] for c in chunks) // hop
        want = tts.generate_tokens(SERVE_TEXTS[i], ref, max_frames=BF16_SERVE_MAX,
                                   seed=SERVE_SEEDS[i]).shape[0]
        if frames != want or not all(np.isfinite(c).all() for c in chunks):
            raise AssertionError(f"bf16 serve session {i}: {frames} frames, generate_tokens {want}")
        audio += frames * hop
    out["serve_audio_s_per_s"] = audio / sr / wall
    log(f"  bf16 serve: 8 sessions on 8 slots, max_frames {BF16_SERVE_MAX}: each as long as its "
        f"generate_tokens; {audio / sr:.2f} s of audio in {wall:.3f} s")

    out["profile"] = {}  # where the time of a batch and a stream goes, fp32 against bf16
    text, seed = STREAM_REQUESTS[0]
    for name, t, r in (("fp32", tts32, ref32), ("bf16", tts, ref)):
        for what, fn in (("batch B=4", lambda t=t, r=r: t.synthesize_batch(
                              texts, ref=r, max_frames=MAX_FRAMES, seeds=seeds)),
                         ("stream", lambda t=t, r=r: list(t.stream(text, ref=r, max_frames=MAX_FRAMES,
                                                                   seed=seed)))):
            busy, n, _, top, wall = profile_steps(lambda _: fn(), None, n=1)
            out["profile"][f"{name} {what}"] = dict(wall_ms=wall * 1e3, busy=busy, launches=n,
                                                    top=top[:3])
            log(f"  profiler, {name} {what}: {wall * 1e3:.1f} ms host wall, kernels busy "
                f"{busy * 100:.1f} %, {n:.0f} kernel launches; largest: "
                + "; ".join(f"{k[:60]} {ms:.2f} ms" for k, ms in top[:3]))

    codes = tts32.generate_tokens(REQUESTS[0][0], ref32, max_frames=MAX_FRAMES, seed=REQUESTS[0][1])
    w32, w16 = tts32.engine.decode(codes), tts.engine.decode(codes)
    snr = 10.0 * np.log10(float((w32.astype(np.float64) ** 2).sum())
                          / max(float(((w16.astype(np.float64) - w32) ** 2).sum()), 1e-30))
    out["snr_db"] = snr
    log(f"  bf16 vs fp32 Mimi decode of the fp32 path's {codes.shape} codes: SNR {snr:.1f} dB "
        f"(the JAX package's TPU claim: {TPU_BF16_SNR_DB:.0f} dB; not gated)")
    return stats, out


# phase 14: serving and batch synthesis over a mesh
MESH_MAX_FRAMES = 96
# the burst's caps: the short ones free slots early, so the 4 later sessions join mid-flight
MESH_CAPS = (96, 96, 96, 96, 32, 48, 64, 80, 96, 96, 96, 96)
MESH_TOKEN_GAP = 1e-5  # a token may differ only at a top-2 margin below this of the peak logit


def mesh_layout():
    """dp = 4 over the first 4 cards where there are 4 or more, dp = 2 over
    2 cards where there are 2 or 3, else dp = 2 with both shards on cuda:0
    (slots 8 and the batch's 4 rows must divide by dp)."""
    from sopro_tpu_torch.parallel import make_mesh

    count = torch.cuda.device_count()
    if count >= 2:
        dp = 4 if count >= 4 else 2
        return make_mesh(dp, dp=dp, tp=1), f"dp = {dp}, one card each (cuda:0 .. cuda:{dp - 1})"
    return (make_mesh(2, dp=2, tp=1, devices=[torch.device("cuda", 0)] * 2),
            "dp = 2, both shards on cuda:0 (one card: a correctness rehearsal; the shards "
            "take turns on one stream, so its throughput is no multi-card number)")


def serve_burst(b, ref, hop, sr):
    """MESH_CAPS' first 8 sessions as a burst, the last 4 once the burst
    decodes -> (handles, chunks per session, wall s, audio s)."""
    t0 = time.perf_counter()
    handles = [b.submit(SERVE_TEXTS[i], ref, seed=SERVE_SEEDS[i], max_frames=MESH_CAPS[i])
               for i in range(8)]
    runs = [collect(h) for h in handles]
    while len(runs[0][0]) < 2 and runs[0][1].is_alive():  # the burst is decoding
        time.sleep(0.002)
    handles += [b.submit(SERVE_TEXTS[i], ref, seed=SERVE_SEEDS[i], max_frames=MESH_CAPS[i])
                for i in range(8, 12)]
    runs += [collect(h) for h in handles[8:]]
    for _, th in runs:
        th.join(timeout=600)
        if th.is_alive():
            raise AssertionError("mesh serve: a session did not finish")
    wall = time.perf_counter() - t0
    chunks = [[c for _, c in got] for got, _ in runs]
    audio = sum(sum(c.shape[1] for c in cs) for cs in chunks) / sr
    for i, cs in enumerate(chunks):
        if cs[0].shape[1] != 4 * hop or any(c.shape[1] != 16 * hop for c in cs[1:-1]):
            raise AssertionError(f"mesh serve session {i}: chunk grid {[c.shape[1] // hop for c in cs]}")
    return handles, chunks, wall, audio


def final_tokens(b, handles, frames):
    """{session: its AR tokens} for the sessions still holding their slot's
    state (a later join into the slot overwrote the others)."""
    last = {h.slot: i for i, h in enumerate(handles)}
    out = {}
    for slot, i in last.items():
        st = b.states[slot // b.per]
        out[i] = st.carry.tokens[slot % b.per, : frames[i]].cpu()
    return out, last


def token_margin(tts, st, row, seed, got, want, what):
    """Where `got` leaves `want` (the unsharded batcher's tokens of the
    session in `row` of state `st`), the plain loop's penalized top-2 margin
    there, replayed from the row's conditioning and key; raises unless it
    is below MESH_TOKEN_GAP of the peak logit."""
    from dataclasses import replace

    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.ops.ar_loop import ar_loop_plain

    eng, n = tts.engine, int(want.shape[0])
    ctx = M.ar_context_from_kv(eng.model, st.kv_k[:, row: row + 1], st.kv_v[:, row: row + 1],
                               st.text_mask[row: row + 1])
    c = replace(M.init_ar_carry(tts.cfg, 1, st.cond.shape[1], 0, eng.device), key=eng._row_keys([seed]))
    fresh = {k: getattr(c, k) for k in ("t", "last", "streak", "stopped", "first_eos", "key", "hist",
                                        "bufs")}
    rec = RecordingContext(ctx)
    plain, _ = ar_loop_plain(rec, st.cond[row: row + 1], fresh, M.ARSettings(
        min_gen_frames=tts.cfg.min_gen_frames).per_row(1, eng.device), n, True)
    if not torch.equal(plain[0, :n].cpu(), want):
        raise AssertionError(f"{what}: the plain replay differs from the unsharded batcher")
    return first_divergence(got[None], want[None], rec.logits, 0, what, tol=MESH_TOKEN_GAP)


def drive_mesh(tts, ref, hop, sr):
    """Phase 14: `ContinuousBatcher(mesh=)` and `synthesize_batch(mesh=)`
    against the unsharded batcher and batch in the same call."""
    from sopro_tpu_torch import kernels
    from sopro_tpu_torch.serve import ContinuousBatcher

    count = torch.cuda.device_count()
    log(f"  torch.cuda.device_count() = {count}; cards: {gpu_lines()}")
    mesh, layout = mesh_layout()
    dp, per = mesh.shape["dp"], 8 // mesh.shape["dp"]
    log(f"  shards: {layout}")
    prod = dict(slots=8, chunk_frames=16, ramp_frames=4, text_bucket=SERVE_TEXT_BUCKET,
                max_frames=MESH_MAX_FRAMES, pcm16=True)
    out = {"dp": dp, "cards": count, "layout": layout}
    runs = {}
    for name, kw in (("unsharded", {}), ("mesh", {"mesh": mesh})):
        b = ContinuousBatcher(tts, **prod, **kw)
        t0 = time.perf_counter()
        b.warmup(ref)
        for eng in b.engines:
            torch.cuda.synchronize(eng.device)
        log(f"  {name} batcher ({len(b.engines)} shard(s)): warmup {time.perf_counter() - t0:.2f} s")
        b.reset_stats()
        kernels.reset_launches()
        handles, chunks, wall, audio = serve_burst(b, ref, hop, sr)
        launches = launched(f"{name} serve", ("ar_loop", "nar_heads", "seanet_chunk"))
        stats = b.stats()
        if launches["seanet"] or launches["ar_step"]:
            raise AssertionError(f"{name} serve launched K3 or K5: {launches}")
        if launches["ar_loop"] != sum(stats["shard_ticks"]) or stats["sessions_done"] != 12:
            raise AssertionError(f"{name} serve: K1 launched {launches['ar_loop']} times, the shards "
                                 f"ran {stats['shard_ticks']} ticks, {stats['sessions_done']} sessions")
        frames = [sum(c.shape[1] for c in cs) // hop for cs in chunks]
        tokens, last = final_tokens(b, handles, frames)
        ttfa = statistics.median(h.first_chunk_s * 1e3 for h in handles[:8])
        runs[name] = dict(b=b, chunks=chunks, frames=frames, tokens=tokens, last=last)
        out[name] = dict(audio_s_per_s=audio / wall, wall_s=wall, audio_s=audio, ticks=stats["ticks"],
                         shard_ticks=stats["shard_ticks"], k1_launches=launches["ar_loop"],
                         launches=launches, burst_ttfa_p50_ms=ttfa,
                         tick_dispatch_ms_p50=stats["tick_dispatch_ms_p50"],
                         shard_dispatch_ms_p50=stats["shard_dispatch_ms_p50"])
        log(f"  {name} serve: 12 sessions (caps {MESH_CAPS}) on 8 slots, {audio:.2f} s of audio in "
            f"{wall:.3f} s = {audio / wall:.1f} s of audio per second; ticks {stats['ticks']}, per "
            f"shard {stats['shard_ticks']} (= K1 launches {launches['ar_loop']}); tick dispatch p50 "
            f"{stats['tick_dispatch_ms_p50']} ms, per shard {stats['shard_dispatch_ms_p50']} ms; burst "
            f"TTFA p50 {ttfa:.2f} ms")

    one, sharded = runs["unsharded"], runs["mesh"]
    worst = 0
    for i in range(12):
        a, m = np.concatenate(one["chunks"][i], axis=1), np.concatenate(sharded["chunks"][i], axis=1)
        if one["frames"][i] != sharded["frames"][i] or a.shape != m.shape:
            raise AssertionError(f"mesh session {i}: {sharded['frames'][i]} frames, unsharded "
                                 f"{one['frames'][i]}")
        diff = int(np.abs(a.astype(np.int32) - m.astype(np.int32)).max(initial=0))
        worst = max(worst, diff)
        if diff > 1:
            raise AssertionError(f"mesh session {i}: PCM differs from the unsharded batcher by {diff} LSB")
    both = sorted(set(one["tokens"]) & set(sharded["tokens"]))
    for i in both:
        got, want = sharded["tokens"][i], one["tokens"][i]
        if not torch.equal(got, want):
            slot = [s for s, j in one["last"].items() if j == i][0]
            token_margin(tts, one["b"].states[0], slot, SERVE_SEEDS[i], got, want, f"mesh session {i}")
    log(f"  per session against the unsharded batcher: frame counts equal for all 12, PCM within "
        f"{worst} LSB, AR tokens equal for the {len(both)} sessions still in their slot {both}")
    out["pcm_max_lsb"], out["token_sessions"] = worst, both

    for name in ("unsharded", "mesh"):
        runs[name]["b"].stop()

    texts, seeds = BATCH
    rows = {}
    for name, kw in (("unsharded", {}), ("mesh", {"mesh": mesh}), ("mesh again", {"mesh": mesh}),
                     ("unsharded again", {})):
        tts.synthesize_batch(texts[:dp], ref=ref, max_frames=8, seeds=seeds[:dp], **kw)  # warm
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rows[name] = tts.synthesize_batch(texts, ref=ref, max_frames=MAX_FRAMES, seeds=seeds, **kw)
        sec = time.perf_counter() - t0
        launches = launched(f"{name} batch", ("ar_loop", "nar_heads", "seanet"))
        audio = sum(w.shape[1] for w in rows[name]) / sr
        out[f"batch_{name.replace(' ', '_')}"] = dict(seconds=sec, audio_s_per_s=audio / sec,
                                                      launches=launches)
        log(f"  batch {name}: B = {len(texts)} x {MAX_FRAMES} frames, {sec:.3f} s, "
            f"{audio / sec:.1f} s of audio per second")
    errs = [close_to(g, w, f"mesh batch row {i}")[0] / max(float(np.abs(w).max()), 1e-30)
            for i, (g, w) in enumerate(zip(rows["mesh"], rows["unsharded"]))]
    log(f"  mesh batch rows against the unsharded batch: lengths equal, max|err| / peak per row "
        f"{[f'{e:.2e}' for e in errs]}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from sopro_tpu_torch import kernels
    from sopro_tpu_torch.codec.mimi_config import MimiConfig
    from sopro_tpu_torch.config import SoproTTSConfig
    from sopro_tpu_torch.engine import configure_cuda_numerics

    configure_cuda_numerics()
    os.environ["HF_HUB_OFFLINE"] = "1"  # phase 9 reads the hub only from a cache it writes
    dev = torch.device("cuda", 0)
    card = gpu_line()
    log(f"[1] device: {torch.cuda.get_device_name(0)} ({torch.cuda.device_count()} visible); "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    log("[2] building kernels")
    build_s = kernels.build()
    log(f"  build: {build_s:.2f} s")
    for name in kernels.SOURCES:
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    check_hopper_sass()

    log("[3] kernels against their plain versions (main-path shapes, fp32, TF32 off)")
    rng = np.random.default_rng(SEED)
    cfg, mcfg = SoproTTSConfig(), MimiConfig()  # the full Sopro v1.5 and Mimi widths
    model, mimi = build_models(dev, SEED, cfg, mcfg)
    stats = {
        "nar_heads": check_nar_heads(model, dev, rng),
        "seanet": check_seanet(mimi, dev, rng),
        "seanet_chunk": check_seanet_chunk(mimi, dev, rng),
        "ar_loop": check_ar_loop(model, mimi, dev, rng),
    }
    stats["ar_step"] = check_ar_step(model, mimi, dev, rng, stats["ar_loop"])
    del model, mimi
    torch.cuda.empty_cache()

    log("[4] synthesize path: SoproTTS.from_random -> prepare_reference -> synthesize x3")
    synth_launches, tts, ref, ref_tokens = drive_main_path(dev, rng, cfg, mcfg)
    log(f"[5] stream path: SoproTTSStreamer.stream x3, max_frames={MAX_FRAMES}, chunk {CHUNK}")
    stream_launches = drive_stream_path(tts, ref)
    log("[6] reference from audio: WAV -> encode_reference -> prepare_reference -> stream")
    drive_reference_audio(tts, ref)
    log(f"[7] batch path: synthesize_batch B={len(BATCH[0])}, synthesize_long")
    _, stats["seanet"]["B4"] = drive_batch_path(tts, ref, dev, rng)
    log("[8] per-step route: RuntimeConfig(use_pallas_resident=False)")
    step_launches = drive_per_step_route(cfg, mcfg, dev, ref_tokens, tts, ref)
    log("[9] checkpoint: save_pretrained, a Mimi snapshot in HF names, from_pretrained")
    drive_checkpoint(tts, ref, ref_tokens, dev, mcfg)
    log("[10] serve: ContinuousBatcher on the card, 8 slots, text bucket 256")
    serve = drive_serve(tts, ref, dev, rng)
    log(f"[11] train: full width, B = {len(TRAIN_LENGTHS)} x S = {TRAIN_S}; card vs CPU, "
        "NCCL world size 1, resume, serving the trained model")
    train, train_tree, train_host = drive_train(tts, ref_tokens, dev, rng, cfg, mcfg)
    log(f"  train summary: {json.dumps(train)}")
    log("[12] CLI: python -m sopro_tpu_torch.cli --random_init --device cuda")
    drive_cli(tts, ref, ref_tokens)
    log("[13] bf16: RuntimeConfig(compute_dtype=\"bfloat16\"), kernels and paths")
    bf16_stats, bf16_paths = drive_bf16(cfg, mcfg, dev, rng, ref_tokens, tts, ref)
    log(f"  bf16 summary: {json.dumps(bf16_paths)}")
    log("[14] mesh: ContinuousBatcher(mesh=) and synthesize_batch(mesh=) against one shard")
    mesh_out = drive_mesh(tts, ref, tts.engine.mimi_cfg.hop_length, tts.engine.mimi_cfg.sampling_rate)
    log(f"  mesh summary: {json.dumps(mesh_out)}")
    log(f"[15] tp training: phase 11's model and batch on (dp, tp) meshes against the unsharded step")
    for line in gpu_lines():
        log(f"  card: {line}")
    tp_out = drive_tp(train_tree, train_host, cfg, train)
    log(f"  tp summary: {json.dumps(tp_out)}")
    del train_tree, train_host

    # each kernel's count from the path it belongs to (K4: the stream, K5: the per-step
    # route), and per request of that path's counted run
    launches = dict(synth_launches, seanet_chunk=stream_launches["seanet_chunk"],
                    ar_step=step_launches["ar_step"])
    requests = dict({name: len(REQUESTS) for name in KERNELS},
                    seanet_chunk=len(STREAM_REQUESTS), ar_step=PER_STEP_REQUESTS)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("bound_rate", "fp32_bound_ms", "err_f64", "plain_err_f64", "by_rows", "B4",
             "chunk16", "serve_b8", "err_f64_worst", "us_per_step", "first_diff_production")
    for name in ("ar_loop", "nar_heads", "seanet_chunk"):
        n = serve["launches"][name]
        stats[name].update(serve_launches=n, serve_launches_per_session=n / serve["sessions"])
    for name in ("ar_loop", "nar_heads", "seanet_chunk"):
        n = mesh_out["mesh"]["launches"][name]
        stats[name].update(mesh_serve_launches=n, mesh_serve_launches_per_session=n / 12)
    stats["ar_loop"]["serve_rows"] = serve["k1_rows"]
    stats["nar_heads"]["serve_tick"] = serve["k2_tick"]
    extra += ("serve_launches", "serve_launches_per_session", "serve_rows", "serve_tick",
              "mesh_serve_launches", "mesh_serve_launches_per_session")
    # the bf16 instantiations: launches from the bf16 path each belongs to
    bf16_launches = dict(bf16_paths["synthesize"], seanet_chunk=bf16_paths["stream"]["seanet_chunk"],
                         ar_step=bf16_paths["per_step"]["ar_step"])
    bf16_extra = ("bound_rate", "design_bound_ms", "by_rows", "B4", "chunk16", "serve_b8",
                  "us_per_step", "first_diff", "state_logit_err", "serve_rows")
    for name in KERNELS:
        s16 = bf16_stats[name]
        stats[name]["bf16"] = dict(launches=bf16_launches[name], **{k: s16[k] for k in keys},
                                   **{k: s16[k] for k in bf16_extra if k in s16})
    extra += ("bf16",)
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "launches_per_request": launches[name] / requests[name],
         **{k: stats[name][k] for k in keys}, **{k: stats[name][k] for k in extra if k in stats[name]}}
        for name, (src, rep) in KERNELS.items()
    ]}
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
