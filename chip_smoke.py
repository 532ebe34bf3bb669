#!/usr/bin/env python3
"""Chip smoke test of the torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises, so the script exits non-zero, on failure):
1. require a CUDA device; print the card's name and power limit;
2. build the three kernels from csrc/ with nvcc (sm_90a) and print the
   build seconds and ptxas' register / shared-memory report;
3. hold each kernel against its plain PyTorch version at the main path's
   shapes (full Sopro v1.5 and Mimi widths, random weights from a seed with
   the zero-initialised leaves filled, TF32 off) and time both with CUDA
   events;
4. drive the main path: `SoproTTS.from_random(device="cuda")`,
   `prepare_reference(ref_tokens_tq=...)`, three `synthesize` requests at
   max_frames=400 (launch counters zeroed just before, read just after),
   plus a repeat that must be identical; print seconds and real-time factor.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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
    "nar_heads": ("sopro_tpu_torch/csrc/nar_heads.cu", "sopro_tpu/ops/pallas_nar.py:53"),
    "seanet": ("sopro_tpu_torch/csrc/seanet.cu", "sopro_tpu/codec/pallas_vocoder.py:353"),
}


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
    from sopro_tpu_torch.ops.nar_heads import nar_heads_argmax, nar_heads_argmax_plain

    worst, mism, ms, plain_ms = 0.0, 0, 0.0, 0.0
    for stage, (hid, w, b) in model.nar.head_stacks().items():
        z = torch.from_numpy(rng.standard_normal((1, MAX_FRAMES + 1, w.shape[1])).astype(np.float32)).to(dev)
        got = nar_heads_argmax(z, hid, w, b)
        want = nar_heads_argmax_plain(z, hid, w, b)
        logits = torch.einsum("bthd,hdv->bthv", z[:, :, None, :] + hid[None, None], w) + b[None, None]
        top2 = torch.topk(logits, 2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        differ = got != want
        bad = int((differ & (margin > 1e-5)).sum())
        if bad:
            raise AssertionError(f"nar_heads stage {stage}: {bad} ids differ at a clear margin")
        mism += int(differ.sum())
        gl = torch.gather(logits, -1, got.long()[..., None])[..., 0]
        worst = max(worst, float((gl - top2[..., 0]).abs().max()))
        ms += cuda_ms(lambda: nar_heads_argmax(z, hid, w, b), 20)
        plain_ms += cuda_ms(lambda: nar_heads_argmax_plain(z, hid, w, b), 20)
        log(f"  nar_heads stage {stage}: H={w.shape[0]} ids differ at {int(differ.sum())} "
            f"near-tie positions of {differ.numel()}")
    log(f"  nar_heads: 4 stages {ms:.3f} ms (kernel) vs {plain_ms:.3f} ms (plain)")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "mismatches": mism}


def check_seanet(mimi, dev, rng):
    from sopro_tpu_torch.codec.mimi import decode_embeddings, seanet_apply
    from sopro_tpu_torch.codec.mimi_config import decoder_plan
    from sopro_tpu_torch.codec.vocoder import seanet_decode

    cfg = mimi.cfg
    codes = torch.from_numpy(
        rng.integers(0, cfg.codebook_size, (1, MAX_FRAMES + 1, cfg.num_quantizers))
    ).to(dev)
    with torch.inference_mode():
        emb = decode_embeddings(mimi.p, cfg, codes).contiguous()
        packed = mimi.packed_decoder()
        got = seanet_decode(packed, cfg, emb)
        want = seanet_apply(mimi.p["decoder"], decoder_plan(cfg), emb)[..., 0]
        torch.cuda.synchronize()
        if tuple(got.shape) != (1, emb.shape[1] * int(np.prod(cfg.upsampling_ratios))):
            raise AssertionError(f"seanet: shape {tuple(got.shape)}")
        err = float((got - want).abs().max())
        peak = float(want.abs().max())
        log(f"  seanet: emb {tuple(emb.shape)} -> wav {tuple(got.shape)}, "
            f"max|err| {err:.3e}, max|wav| {peak:.3e}")
        if not err <= 1e-4 * peak:
            raise AssertionError(f"seanet: max|err| {err} > 1e-4 * max|wav| {peak}")
        ms = cuda_ms(lambda: seanet_decode(packed, cfg, emb), 5)
        plain_ms = cuda_ms(lambda: seanet_apply(mimi.p["decoder"], decoder_plan(cfg), emb), 5)
    log(f"  seanet: {ms:.3f} ms (kernel) vs {plain_ms:.3f} ms (plain)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
    from sopro_tpu_torch import kernels

    log(f"  ar_loop: {out['steps']} steps {out['ms']:.3f} ms (kernel) vs "
        f"{out['plain_ms']:.3f} ms (plain); launch {kernels.LAUNCH_INFO.get('ar_loop')}")
    return out


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
    launches = dict(kernels.LAUNCHES)
    log(f"  launches during the run: {launches}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"main path did not launch: {missing}")
    text, seed = REQUESTS[0]
    again = tts.synthesize(text, ref=ref, max_frames=MAX_FRAMES, seed=seed)
    first = tts.synthesize(text, ref=ref, max_frames=MAX_FRAMES, seed=seed)
    if not np.array_equal(again, first):
        raise AssertionError("synthesize: a repeated request gave a different waveform")
    return launches, results


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
    for name in kernels.KERNELS:
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
        "ar_loop": check_ar_loop(model, mimi, dev, rng),
    }
    del model, mimi
    torch.cuda.empty_cache()

    log("[4] main path: SoproTTS.from_random -> prepare_reference -> synthesize x3")
    launches, _ = drive_main_path(dev, rng, cfg, mcfg)

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"]}
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
