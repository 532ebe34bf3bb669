"""Ablations of kernels K2 and K3 on one NVIDIA GPU: what each part of the
kernels costs, and what the chunked accumulation buys in accuracy.

    python -m sopro_tpu_torch.bench_ablation [--out PATH]

Builds the tree's sources again with each entry of ABLATIONS, text edits
(`kernels.build_variant`: an edit whose text is missing fails the run
before nvcc runs): the kernels (K2, K3's conv and fused residual blocks)
without their MMAs, the conv kernel without its A fragments, its ELU pass,
its epilogue, or with one accumulator through all of K; K2 and the conv
reading only the hi weight tiles (half the weight bytes); the fused block
without its ELU pass, its residual loads, its final conv or its epilogue.
Swaps each build in for the tree's (`kernels.using`) and times on the same
inputs, in one process: every K3 launch at B = 1 (emb [1, 802, 512] of
N(0, 0.25)), the whole of K3 at B = 1 and 4 with its largest error over the
float32 plain version's peak, and K2's four stages at 401 and 1,604 rows.
Full Sopro v1.5 and Mimi widths, random weights from seed 0, TF32 off,
CUDA-event medians. An ablated build computes wrong numbers; only its time
is read (its error shows how wrong). Prints a table and writes it as JSON
to PATH (default build/bench_ablation.json).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from sopro_tpu_torch import kernels
from sopro_tpu_torch.bench_kernels import cuda_ms

WGMMA_CALLS = {  # source -> its float32 wgmma calls (K3: the conv, then the fused block's two convs)
    "seanet.cu": tuple(f"hopper::wgmma_tf32_n128(part, {a}[ks], {d} + 2 * ks, {sc});"
                       for a, d, sc in (("alo", "dhi", "ks > 0"), ("ahi", "dlo", "1"), ("ahi", "dhi", "1")))
    + tuple(f"hopper::wgmma_tf32<H>(part1, {a}[ks], {d} + 2 * ks, {sc});"
            for a, d, sc in (("alo", "dhi", "ks > 0"), ("ahi", "dlo", "1"), ("ahi", "dhi", "1")))
    + tuple(f"hopper::wgmma_tf32<C>(acc2, {a}[j], {d}, 1);"
            for a, d in (("alo", "dhi"), ("ahi", "dlo"), ("ahi", "dhi"))),
    "nar_heads.cu": tuple(f"hopper::wgmma_tf32_n256(acc, {a}[ks], {d} + 2 * ks, 1);"
                          for a, d in (("alo", "dhi"), ("ahi", "dlo"), ("ahi", "dhi"))),
}
# name -> [(source file, text, replacement)]
ABLATIONS = {
    "wgmma: no MMAs": [(f, call, "") for f, calls in WGMMA_CALLS.items() for call in calls],
    "conv: no A fragments": [(
        "seanet.cu",
        "tf32x3::split(*reinterpret_cast<const float*>(at + hopper::sw128(ra + 8 * (i & 1), 4 * k)), hi, lo);",
        "tf32x3::split((float)k, hi, lo);",
    )],
    "conv: no ELU pass": [("seanet.cu", "        if ((a.elu & 1) || mask) {", "        if (false) {")],
    "conv: no epilogue": [("seanet.cu", "      if (t >= a.T_out || n >= a.N) return;",
                           "      if (t >= 0) return;"),
                          ("seanet.cu", "    if (a.splits == 1 && a.store_tma) {",
                           "    if (a.splits == 1 && a.store_tma && false) {")],
    "conv: no lo tiles": [  # half the weight bytes: the lo pass reads the hi tile
        ("seanet.cu", "hopper::mbar_expect_tx(&bfull[sb], W::BSTAGE);",
         "hopper::mbar_expect_tx(&bfull[sb], W::B_BYTES);"),
        ("seanet.cu", "              if constexpr (W::F32)\n"
                      "                hopper::tma_load_2d(d + W::B_BYTES, &maps.wlo,",
         "              if constexpr (false)\n                hopper::tma_load_2d(d + W::B_BYTES, &maps.wlo,"),
        ("seanet.cu", "const uint64_t dlo = hopper::desc_k128(bt + W::B_BYTES);",
         "const uint64_t dlo = dhi;"),
    ],
    "K2: no lo tiles": [
        ("nar_heads.cu", "hopper::mbar_expect_tx(&full[s], T::STAGE);",
         "hopper::mbar_expect_tx(&full[s], T::STAGE - (T::F32 ? T::B_BYTES : 0));"),
        ("nar_heads.cu", "        if constexpr (T::F32)\n          hopper::tma_load_2d(st + T::A_BYTES + T::B_BYTES,",
         "        if constexpr (false)\n          hopper::tma_load_2d(st + T::A_BYTES + T::B_BYTES,"),
        ("nar_heads.cu", "const uint64_t dlo = hopper::desc_k128(st + T::A_BYTES + T::B_BYTES);",
         "const uint64_t dlo = dhi;"),
    ],
    "resblock: no ELU pass": [("seanet.cu", "      for (int v = tid - 288; v < R::XBOX * R::RX * 8; v += 96) {",
                               "      for (int v = tid - 288; v < 0; v += 96) {")],
    "resblock: no residual loads": [("seanet.cu", "      if (a0 + t >= 0 && a0 + t < a.T_in) {",
                                     "      if (false) {")],
    "resblock: no final conv": [("seanet.cu", "      for (int o0 = 0; o0 < BMO; o0 += 64) {",
                                 "      for (int o0 = 0; o0 < 0; o0 += 64) {")],
    "resblock: no epilogue": [("seanet.cu", "    for (int i = 0; i < C / 2; i += 2) {\n      const int r = rw",
                               "    for (int i = 0; i < 0; i += 2) {\n      const int r = rw")],
    "conv: one accumulator": [  # per tile, through all of K
        ("seanet.cu", "hopper::wgmma_tf32_n128(part, alo[ks], dhi + 2 * ks, ks > 0);",
         "hopper::wgmma_tf32_n128(part, alo[ks], dhi + 2 * ks, ks > 0 || c > 0 || j > 0);"),
        ("seanet.cu", "        for (int i = 0; i < 64; ++i) acc[i] += part[i];\n", ""),
        ("seanet.cu", "make_float2(acc[i], acc[i + 1])", "make_float2(part[i], part[i + 1])"),
    ],
}
SOURCES = ("nar_heads", "seanet")


def build_copies() -> dict:
    """{name: {source: CDLL}} for the tree ("as is") and every ablation: each
    source with the ablation's edits of it built by `kernels.build_variant`
    (the builds run side by side), a source it leaves alone the tree's."""
    tree = {src: kernels.lib(src) for src in SOURCES}
    with ThreadPoolExecutor(8) as pool:
        jobs = {name: {src: pool.submit(kernels.build_variant, src, edits=mine)
                       for src in SOURCES
                       if (mine := [(old, new) for f, old, new in edits if f == f"{src}.cu"])}
                for name, edits in ABLATIONS.items()}
    return {"as is": tree, **{name: {src: built[src].result() if src in built else tree[src]
                                     for src in SOURCES}
                              for name, built in jobs.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=Path("build/bench_ablation.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_ablation: no CUDA device", file=sys.stderr)
        return 2
    from sopro_tpu_torch import weights as W
    from sopro_tpu_torch.codec.mimi import seanet_apply
    from sopro_tpu_torch.codec.mimi_config import MimiConfig, decoder_plan
    from sopro_tpu_torch.codec.vocoder import _conv_cuda, _resblock_cuda, seanet_decode
    from sopro_tpu_torch.config import SoproTTSConfig
    from sopro_tpu_torch.engine import configure_cuda_numerics
    from sopro_tpu_torch.ops.nar_heads import nar_heads_argmax

    configure_cuda_numerics()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    kernels.build(SOURCES)
    libs = build_copies()
    mcfg, cfg = MimiConfig(), SoproTTSConfig()
    mtree, tree = W.init_mimi_params(0, mcfg), W.init_sopro_params(0, cfg, 259)
    W.fill_zero_inits(tree, mtree, 1)
    mimi, model = W.mimi_params_from_jax(mtree, mcfg, dev), W.sopro_params_from_jax(tree, cfg, dev)
    packed, stacks = mimi.packed_decoder(), model.nar.head_stacks()
    g = torch.Generator().manual_seed(0)
    emb = {b: (torch.randn(b, 802, 512, generator=g) * 0.5).to(dev) for b in (1, 4)}
    with torch.inference_mode():
        want = {b: seanet_apply(mimi.p["decoder"], decoder_plan(mcfg), emb[b])[..., 0]
                for b in emb}
    z = {r: torch.randn(1, r, 256, generator=g).to(dev) for r in (401, 1604)}

    def use(name):
        stack = contextlib.ExitStack()
        for src in SOURCES:
            stack.enter_context(kernels.using(src, libs[name][src]))
        return stack

    # every launch's input, from running the tree's K3 once
    cases, x, block_in = [], emb[1], None
    with torch.inference_mode():
        for i, launch in enumerate(packed["k3"]):
            if launch["kind"] == "resblock":
                cases.append((f"{i} resblock {launch['c']}", launch, x, None))
                x = _resblock_cuda(launch, x)
            else:
                res = block_in if launch["residual"] else None
                if not launch["residual"]:
                    block_in = x
                cases.append((f"{i} conv k{launch['taps']} {launch['cin']}->{launch['n']}",
                              launch, x, res))
                x = _conv_cuda(launch, x, res)

    result = {"card": card, "rows": []}
    print(card)
    with torch.inference_mode():
        for name in libs:
            with use(name):
                row = {"ablation": name, "launch_ms": {}}
                for cname, launch, xin, res in cases:
                    if launch["kind"] == "resblock":
                        fn = (lambda launch=launch, xin=xin: _resblock_cuda(launch, xin))
                    else:
                        fn = (lambda launch=launch, xin=xin, res=res: _conv_cuda(launch, xin, res))
                    row["launch_ms"][cname] = cuda_ms(fn, 5)
                for b in emb:
                    wav = seanet_decode(packed, mcfg, emb[b])
                    row[f"k3_b{b}_ms"] = cuda_ms(lambda b=b: seanet_decode(packed, mcfg, emb[b]), 5)
                    row[f"k3_b{b}_err_over_peak"] = float((wav - want[b]).abs().max()
                                                          / want[b].abs().max())
                for r, zr in z.items():
                    row[f"k2_{r}_ms"] = sum(cuda_ms(lambda s=s, zr=zr: nar_heads_argmax(zr, *s), 10)
                                            for s in stacks.values())
                result["rows"].append(row)
                print(f"{name:22s} | " + " | ".join(f"{k} {v:.4f}" for k, v in row["launch_ms"].items())
                      + " | " + " | ".join(f"{k} {v:.4g}" for k, v in row.items()
                                           if k not in ("ablation", "launch_ms")), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
