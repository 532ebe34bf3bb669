"""Ablations of kernels K2 and K3 on one NVIDIA GPU: what each part of the
kernels costs, and what the chunked accumulation buys in accuracy.

    python -m sopro_tpu_torch.bench_ablation [--out PATH]

Builds copies of `csrc/` with one text edit each (ABLATIONS; an edit whose
text is missing fails the run), loads each copy in place of the tree's
kernels, and times on the same inputs, in one process: every K3 launch at
B = 1 (emb [1, 802, 512] of N(0, 0.25)), the whole of K3 at B = 1 and 4 with
its largest error over the float32 plain version's peak, and K2's four
stages at 401 and 1,604 rows. Full Sopro v1.5 and Mimi widths, random
weights from seed 0, TF32 off, CUDA-event medians. An ablated copy computes
wrong numbers; only its time is read (its error shows how wrong). Prints a
table and writes it as JSON to PATH (default build/bench_ablation.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from sopro_tpu_torch import kernels
from sopro_tpu_torch.bench_kernels import cuda_ms

MMA_LINES = tuple(
    f"      for (int nt = 0; nt < NT; ++nt) mma(acc[mt][nt], {a}[mt], {b}[nt]);"
    for a, b in (("al", "bh"), ("ah", "bl"), ("ah", "bh"))
)
# name -> [(source file, text, replacement)]
ABLATIONS = {
    "no MMAs": [("tf32x3.cuh", line, "      for (int nt = 0; nt < 0; ++nt) {}")
                for line in MMA_LINES],
    "conv: no weight loads": [(
        "seanet.cu",
        "        tf32x3::cp_async16(wd + (half * wrows + kk) * kTcLDB + c4, src, true);",
        "        (void)src;",
    )],
    "conv: no ELU or split": [(
        "seanet.cu",
        "        if (a.elu_in) v = elu(v);\n"
        "        tf32x3::split(v, a_hi[r * Tl::LDA + k], a_lo[r * Tl::LDA + k]);",
        "        a_hi[r * Tl::LDA + k] = v;",
    )],
    "one accumulator": [
        ("seanet.cu", "    float part[Tl::MT][Tl::NT][4];\n    tf32x3::zero(part);",
         "    float (&part)[Tl::MT][Tl::NT][4] = acc;"),
        ("seanet.cu", "    tf32x3::add(acc, part);", ""),
        ("seanet.cu", "        float part[R::MT][R::NT1][4];\n        tf32x3::zero(part);",
         "        float (&part)[R::MT][R::NT1][4] = acc1;"),
        ("seanet.cu", "        tf32x3::add(acc1, part);", ""),
    ],
}
SOURCES = ("nar_heads", "seanet")


def build_copies(root: Path) -> dict:
    """{name: {source: CDLL}} for the tree ("as is") and every ablation."""
    csrc = kernels.CSRC
    files = [p.name for p in csrc.glob("*.cu*")]
    jobs = []
    for i, (name, edits) in enumerate([("as is", [])] + list(ABLATIONS.items())):
        d = root / f"ablation_{i}"
        d.mkdir(parents=True, exist_ok=True)
        for f in files:
            text = (csrc / f).read_text()
            for ef, old, new in edits:
                if ef == f:
                    if old not in text:
                        raise RuntimeError(f"ablation {name!r}: text not found in {f}")
                    text = text.replace(old, new)
            (d / f).write_text(text)
        for src in SOURCES:
            out = d / f"lib{src}.so"
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out), str(d / f"{src}.cu")]
            jobs.append((name, src, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                          stderr=subprocess.STDOUT)))
    libs: dict = {}
    for name, src, out, proc in jobs:
        log = proc.communicate()[0].decode()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r} {src}.cu:\n{log[-3000:]}")
        libs.setdefault(name, {})[src] = ctypes.CDLL(str(out))
    return libs


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
    libs = build_copies(kernels.BUILD_DIR.parent)
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
        for src in SOURCES:
            kernels._LIBS[src] = libs[name][src]

    use("as is")  # every launch's input, from running the tree's K3 once
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
            use(name)
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
