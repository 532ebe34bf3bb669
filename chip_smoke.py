#!/usr/bin/env python3
"""Chip smoke test of the torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises, so the script exits non-zero, on failure):
1. require a CUDA device; print the card's name and power limit;
2. build the kernels' sources from csrc/ with nvcc (sm_90a), one nvcc each,
   all started together, and print the build seconds and ptxas' register /
   shared-memory report;
3. hold each of the five kernels against its plain PyTorch version at the
   main paths' shapes (full Sopro v1.5 and Mimi widths, random weights from
   a seed with the zero-initialised leaves filled, TF32 off) and time both
   with CUDA events; K4 at chunks of 6 and 16 AR frames (12 and 32 25 Hz
   rows; B = 1, and B = 2 with partial histories) and 802 rows, against
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
The last three lines are the card's name and power limit, the kernels' JSON
record and {"ok": true, "device": {...}}. Per kernel the record holds its
launches in its path's counted run and per request of that run, its time,
its plain version's, the library's (K2: einsum + argmax; K3 and K4: the
stack as cuDNN convs, `bench_kernels.seanet_library`; K1 and K5: none), and
its bound (`bench_kernels.bound`: bytes over HBM's rate, or operations over
the 3-pass TF32 rate for the tensor-core kernels K2, K3 and K4 and the fp32
rate for K1 and K5); K2 also at 6, 187, 401 and 1,604 rows, K3 also at
B = 4, K4 also at chunk 16, with errors against float64 plain versions.
"""

from __future__ import annotations

import json
import os
import statistics
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


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


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
                             (2, 32, (3, halo)), (1, 2 * (MAX_FRAMES + 1), None)):
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
    return dict(out[(1, 2 * CHUNK, None)], max_abs_err=worst,
                chunk16=out[(1, 32, None)], err_f64_worst=max(v["err_f64"] for v in out.values()))


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from sopro_tpu_torch import kernels
    from sopro_tpu_torch.codec.mimi_config import MimiConfig
    from sopro_tpu_torch.config import SoproTTSConfig
    from sopro_tpu_torch.engine import configure_cuda_numerics

    configure_cuda_numerics()
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

    # each kernel's count from the path it belongs to (K4: the stream, K5: the per-step
    # route), and per request of that path's counted run
    launches = dict(synth_launches, seanet_chunk=stream_launches["seanet_chunk"],
                    ar_step=step_launches["ar_step"])
    requests = dict({name: len(REQUESTS) for name in KERNELS},
                    seanet_chunk=len(STREAM_REQUESTS), ar_step=PER_STEP_REQUESTS)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("bound_rate", "fp32_bound_ms", "err_f64", "plain_err_f64", "by_rows", "B4",
             "chunk16", "err_f64_worst", "us_per_step", "first_diff_production")
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
