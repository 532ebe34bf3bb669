"""Command line of the torch port (counterpart: sopro_tpu/cli.py):

    python -m sopro_tpu_torch.cli --text "Hello." --ref_tokens ref.npy --out out.wav

The JAX CLI's flags, with these differences: `--device {cuda,cpu}` (the
card unless the caller asks for the CPU); `--repo` is a local snapshot
directory and `--mimi_repo` the Mimi snapshot's, as `SoproTTS.from_pretrained`
takes them; `--revision`, `--cache_dir` and `--token` are parsed so the JAX
CLI's command lines run, and are unused (nothing is downloaded);
`--trace_dir` writes a `torch.profiler` Chrome trace of the generation
(`profiling.device_trace`). `--random_init` builds random weights from
`--seed`; `--stream` runs the chunked path, `--long` the long-form one;
`--metrics_json` prints the utterance's metrics as JSON on stdout. A bad
combination of reference arguments exits with code 2 before the model is
built.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from sopro_tpu_torch.constants import DEFAULT_MIMI_ID, TARGET_SR


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m sopro_tpu_torch.cli", description="Sopro TTS (PyTorch/CUDA port)"
    )
    p.add_argument("--repo", default="samuel-vitorino/sopro-v1.5",
                   help="local snapshot directory of the Sopro checkpoint")
    p.add_argument("--mimi_repo", default=DEFAULT_MIMI_ID,
                   help="local snapshot directory of the Mimi codec")
    p.add_argument("--revision", default=None, help="unused: nothing is downloaded")
    p.add_argument("--cache_dir", default=None, help="unused: nothing is downloaded")
    p.add_argument("--token", default=None, help="unused: nothing is downloaded")
    p.add_argument("--text", required=True)
    p.add_argument("--ref_audio", default=None, help="reference audio file (wav, mp3, ogg)")
    p.add_argument("--ref_tokens", default=None, help=".npy file of Mimi tokens [T, Q]")
    p.add_argument("--out", default="sopro_out.wav")
    p.add_argument("--max_frames", type=int, default=400)
    p.add_argument("--top_p", type=float, default=0.9)
    p.add_argument("--temperature", type=float, default=1.05)
    p.add_argument("--no_anti_loop", action="store_true")
    p.add_argument("--style_strength", type=float, default=None)
    p.add_argument("--ref_seconds", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--stream", action="store_true", help="use the chunked streaming path")
    p.add_argument("--long", action="store_true",
                   help="long-form mode: split the text into sentence chunks, synthesize "
                        "them as one batch, join them with --gap_ms of silence")
    p.add_argument("--gap_ms", type=float, default=120.0)
    p.add_argument("--chunk_frames", type=int, default=6)
    p.add_argument("--random_init", action="store_true",
                   help="random weights from --seed instead of a checkpoint")
    p.add_argument("--metrics_json", action="store_true",
                   help="print the utterance's metrics as JSON")
    p.add_argument("--trace_dir", default=None,
                   help="write a torch.profiler Chrome trace of the generation here")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.stream and args.long:
        print("error: --stream and --long are mutually exclusive", file=sys.stderr)
        return 2

    import numpy as np

    from sopro_tpu_torch.profiling import GenerationMetrics, Timer, device_trace
    from sopro_tpu_torch.tts import SoproTTS

    def log(msg):
        if not args.quiet:
            print(msg, file=sys.stderr)

    # check the reference arguments before the (slow) model build
    ref_tokens = np.load(args.ref_tokens).astype(np.int32) if args.ref_tokens else None
    if (ref_tokens is None) == (args.ref_audio is None):
        print("error: provide exactly one of --ref_audio / --ref_tokens", file=sys.stderr)
        return 2

    timer = Timer()
    with timer.section("load"):
        if args.random_init:
            tts = SoproTTS.from_random(seed=args.seed, device=args.device)
        else:
            tts = SoproTTS.from_pretrained(args.repo, mimi_repo_id=args.mimi_repo,
                                           device=args.device)
    log(f"model loaded in {timer.sections['load']:.1f}s")

    with timer.section("reference"):
        ref = tts.prepare_reference(ref_audio_path=args.ref_audio, ref_tokens_tq=ref_tokens,
                                    ref_seconds=args.ref_seconds)
    log(f"reference prepared in {timer.sections['reference']:.1f}s")

    kwargs = dict(ref=ref, max_frames=args.max_frames, top_p=args.top_p,
                  temperature=args.temperature, anti_loop=not args.no_anti_loop,
                  style_strength=args.style_strength, seed=args.seed)
    metrics = GenerationMetrics()
    trace = (device_trace(args.trace_dir, device=args.device) if args.trace_dir
             else contextlib.nullcontext())
    t0 = time.perf_counter()
    with trace, timer.section("generate"):
        if args.stream:
            chunks = []
            for c in tts.stream(args.text, chunk_frames=args.chunk_frames, **kwargs):
                if metrics.ttfa_s is None:
                    metrics.ttfa_s = time.perf_counter() - t0
                    log(f"TTFA {metrics.ttfa_s * 1000:.0f} ms")
                chunks.append(c)
            wav = np.concatenate(chunks, axis=1) if chunks else np.zeros((1, 0), np.float32)
        elif args.long:
            wav = tts.synthesize_long(args.text, pcm16=True, gap_ms=args.gap_ms, **kwargs)
        else:
            wav = tts.synthesize(args.text, pcm16=True, **kwargs)

    metrics.wall_s = timer.sections["generate"]
    metrics.audio_s = wav.shape[1] / TARGET_SR
    metrics.frames = wav.shape[1] // tts.engine.mimi_cfg.hop_length
    tts.save_wav(args.out, wav)
    log(f"generated {metrics.audio_s:.2f}s audio in {metrics.wall_s:.2f}s "
        f"(RTF {metrics.rtf:.3f}, {metrics.frames_per_s:.0f} frames/s) -> {args.out}")
    log(timer.report())
    if args.metrics_json:
        print(json.dumps(metrics.to_dict()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
