"""A small configuration and traffic for driving the harness on the CPU:
the program runs its plain versions there, so a whole run (weights, traffic,
the program, the check) takes seconds."""

from __future__ import annotations

import json
import os
import shutil

SOPRO = dict(num_codebooks=8, codebook_size=32, max_frames=20, d_model=64,
             n_layers_text=1, dropout=0.0, pos_emb_max=64, max_text_len=32,
             n_layers_ar=2, ar_kernel=5, ar_dilation_cycle=[1, 2], ar_text_attn_freq=2,
             min_gen_frames=3, n_layers_nar=2, nar_head_dim=32, nar_kernel_size=5,
             nar_dilation_cycle=[1, 2], stage_B=[2, 3], stage_C=[4, 5], stage_D=[6, 7],
             stage_E=[8, 8], sv_student_dim=16, ref_enc_layers=1, ref_xattn_heads=2,
             ref_xattn_layers=2)
MIMI = dict(hidden_size=32, num_filters=4, upsampling_ratios=[4, 3], codebook_size=32,
            codebook_dim=8, num_quantizers=8, vector_quantization_hidden_dimension=8,
            num_semantic_quantizers=1, upsample_groups=32, num_hidden_layers=2,
            intermediate_size=64, num_attention_heads=2, num_key_value_heads=2,
            head_dim=16, sliding_window=6, frame_rate=1000.0)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def override(cfg, mix):
    """The cell's configuration and mix at the small size."""
    cfg = dict(cfg, sopro=dict(cfg["sopro"], **SOPRO), mimi=dict(cfg["mimi"], **MIMI), text_vocab=64)
    mix = dict(mix, text_len=[4, 20], refs=dict(mix["refs"], frames=10),
               check=dict(mix["check"], keep=1.0))
    if mix["entry"] == "serve":
        mix = dict(mix, frames=[6, 20], lead_s=0.5,
                   batcher=dict(mix["batcher"], chunk_frames=4, ramp_frames=2, text_bucket=32,
                                max_frames=20))
        if mix["loop"] == "open":
            mix["rate"] = 6.0
        elif "mesh" in mix["batcher"]:  # 4 shards of 2 slots on the CPU
            mix["batcher"]["slots"] = 8
            mix.update(clients=16)
        else:
            mix.update(clients=12)
    else:
        mix = dict(mix, frames=[20, 20], lead_s=0.5)
    return cfg, mix


def checkout(tmp, extra=None):
    """A copy of BENCHMARK.json and the files the harness finds by name
    under `tmp`, with `extra` ({relative path: JSON object}) written beside
    them."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), os.path.join(tmp, "BENCHMARK.json"))
    for d in ("configs", "traffic", "limits", "metrics", "entries", "families"):
        shutil.copytree(os.path.join(REPO, "cudabench", d), os.path.join(tmp, "cudabench", d),
                        ignore=shutil.ignore_patterns("*.py" if d == "traffic" else "__init__.py",
                                                      "__pycache__"))
    for rel, obj in (extra or {}).items():
        path = os.path.join(tmp, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(obj, f)
    return str(tmp)
