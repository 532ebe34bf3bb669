"""The weight bridge: parameter trees as numpy arrays -> the port's modules.

The trees have the JAX package's layout and key names
(`sopro_tpu.models.sopro.init_sopro_model`, `sopro_tpu.codec.convert`), so
`sopro_params_from_jax(jax_tree_as_numpy, ...)` makes a model that computes
the same function as the JAX one. `init_sopro_params` / `init_mimi_params`
draw random trees of the same shapes and scales from a numpy seed (the bits
differ from the JAX package's `jax.random` draws).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from sopro_tpu_torch.codec.mimi import MimiDecoder
from sopro_tpu_torch.codec.mimi_config import CONV, CONVT, RESNET, MimiConfig, decoder_plan, upsample_spec
from sopro_tpu_torch.config import SoproTTSConfig
from sopro_tpu_torch.models.base import tree_map
from sopro_tpu_torch.models.generator import has_xattn
from sopro_tpu_torch.models.sopro import SoproModel

Tree = Dict[str, Any]
MIMI_DECODE_KEYS = ("quantizer", "upsample", "dec_tf", "decoder")


def to_torch(tree: Any, device) -> Any:
    """numpy (or array-like) leaves -> torch tensors on `device`; floats
    become float32."""
    def leaf(a):
        a = np.asarray(a)
        t = torch.from_numpy(np.ascontiguousarray(a))
        if t.is_floating_point():
            t = t.float()
        return t.to(device)
    return tree_map(leaf, tree)


def sopro_params_from_jax(tree: Tree, cfg: SoproTTSConfig, device) -> SoproModel:
    return SoproModel(to_torch(tree, device), cfg)


def mimi_params_from_jax(tree: Tree, cfg: MimiConfig, device) -> MimiDecoder:
    """Keeps the decode half: quantizer `dec_embed`, upsample, decoder
    transformer and SEANet decoder."""
    dec = {k: tree[k] for k in MIMI_DECODE_KEYS}
    dec["quantizer"] = {"dec_embed": tree["quantizer"]["dec_embed"]}
    return MimiDecoder(to_torch(dec, device), cfg)


# --------------------------------------------------------------------------
# random trees (numpy-seeded)
# --------------------------------------------------------------------------


class _Init:
    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def uniform(self, shape, bound):
        return self.rng.uniform(-bound, bound, shape).astype(np.float32)

    def normal(self, shape, scale=1.0):
        return (self.rng.standard_normal(shape) * scale).astype(np.float32)

    def linear(self, d_in, d_out, bias=True):
        bound = 1.0 / math.sqrt(d_in)
        p = {"w": self.uniform((d_in, d_out), bound)}
        if bias:
            p["b"] = self.uniform((d_out,), bound)
        return p

    def dwconv(self, d, k):
        bound = 1.0 / math.sqrt(k)
        return {"w": self.uniform((k, 1, d), bound), "b": self.uniform((d,), bound)}

    def ssmlite(self, d, k):
        return {
            "norm": _ones(d), "glu": {"pro": self.linear(d, 2 * d)},
            "dw": self.dwconv(d, k), "ff_norm": _ones(d),
            "ff1": self.linear(d, 4 * d), "ff2": self.linear(4 * d, d),
        }

    def xattn(self, d):
        return {
            "nq": _ones(d), "nkv": _ones(d),
            "q": self.linear(d, d, False), "k": self.linear(d, d, False),
            "v": self.linear(d, d, False), "out": self.linear(d, d, False),
            "gate": np.zeros((), np.float32),
        }


def _ones(d):
    return {"scale": np.ones((d,), np.float32)}


def init_sopro_params(seed: int, cfg: SoproTTSConfig, text_vocab_size: int) -> Tree:
    """Random Sopro tree with the shapes and scales of `init_sopro_model`
    (zero-initialised gates, FiLM output, head-id offsets and mixes)."""
    ini = _Init(seed)
    d, q = int(cfg.d_model), int(cfg.num_codebooks)
    stages = cfg.stage_order()
    stage_idx = cfg.stage_indices()
    n_ar = int(cfg.n_layers_ar)
    return {
        "text_enc": {
            "embed": {"emb": ini.normal((text_vocab_size, d))},
            "layers": [ini.ssmlite(d, 7) for _ in range(cfg.n_layers_text)],
            "norm": _ones(d),
        },
        "cb_embed": {"emb": ini.normal((q * cfg.codebook_size + 1, d))},
        "nar_prev_cb_weights": np.zeros((q,), np.float32),
        "token2sv": {
            "emb": {"emb": ini.normal((q * cfg.codebook_size, 192))},
            "cb_weights": np.linspace(1.0, 0.1, q, dtype=np.float32),
            "conv1": ini.dwconv(192, 7), "conv2": ini.dwconv(192, 7),
            "pool": {"a1": ini.linear(192, 192), "a2": ini.linear(192, 1)},
            "proj": ini.linear(2 * 192, cfg.sv_student_dim),
        },
        "spk_film": {
            "mlp1": ini.linear(cfg.sv_student_dim, d),
            "mlp2": {"w": np.zeros((d, 2 * d), np.float32), "b": np.zeros((2 * d,), np.float32)},
            "norm": {"scale": np.ones((d,), np.float32), "bias": np.zeros((d,), np.float32)},
        },
        "ar": {
            "blocks": [ini.ssmlite(d, cfg.ar_kernel) for _ in range(n_ar)],
            "xattn": [ini.xattn(d) if has_xattn(cfg, i) else None for i in range(n_ar)],
            "norm": _ones(d),
            "head": ini.linear(d, cfg.ar_vocab),
        },
        "nar": {
            "blocks": [ini.ssmlite(d, cfg.nar_kernel_size) for _ in range(cfg.n_layers_nar)],
            "norm": _ones(d),
            "pre": ini.linear(d, cfg.nar_head_dim),
            "stage_emb": {"emb": ini.normal((len(stages), d))},
            "adapter": {
                "norm": _ones(d), "mlp1": ini.linear(d, 256),
                "mlp2": {"w": np.zeros((256, 2 * d), np.float32),
                         "b": np.zeros((2 * d,), np.float32)},
            },
            "heads": {s: [ini.linear(cfg.nar_head_dim, cfg.codebook_size)
                          for _ in stage_idx[s]] for s in stages},
            "head_id_emb": {s: {"emb": np.zeros((len(stage_idx[s]), cfg.nar_head_dim), np.float32)}
                            for s in stages},
            "mix": {s: np.zeros((2,), np.float32) for s in stages},
        },
        "cond_norm": _ones(d),
        "ref_enc_blocks": [ini.ssmlite(d, 7) for _ in range(cfg.ref_enc_layers)],
        "ref_enc_norm": _ones(d),
        "ref_xattn": [ini.xattn(d) for _ in range(cfg.ref_xattn_layers)],
        "ref_cb_weights": np.linspace(1.0, 0.1, q, dtype=np.float32),
    }


def init_mimi_params(seed: int, cfg: MimiConfig) -> Tree:
    """Random Mimi decode tree with the shapes and scales of
    `sopro_tpu.codec.convert.init_mimi_params` (N(0, 0.02) weights, zero
    conv biases, unit codebooks folded through the output projections)."""
    ini = _Init(seed)
    g = lambda *shape, scale=0.02: ini.normal(shape, scale)

    def conv_p(spec):
        groups = int(spec.get("groups", 1))
        return {"w": g(spec["k"], spec["in"] // groups, spec["out"]),
                "b": np.zeros((spec["out"],), np.float32)}

    decoder = []
    for kind, spec in decoder_plan(cfg):
        if kind in (CONV, CONVT):
            decoder.append(conv_p(spec))
        elif kind == RESNET:
            decoder.append({"convs": [conv_p(cs) for cs in spec["convs"]]})
        else:
            decoder.append({})

    d, i = cfg.hidden_size, cfg.intermediate_size
    kvd = cfg.num_key_value_heads * cfg.head_dim
    qd = cfg.num_attention_heads * cfg.head_dim
    ln = lambda: {"scale": np.ones((d,), np.float32), "bias": np.zeros((d,), np.float32)}
    ls = lambda: np.full((d,), cfg.layer_scale_initial_scale, np.float32)
    dec_tf = {"layers": [
        {"ln1": ln(), "q": {"w": g(d, qd)}, "k": {"w": g(d, kvd)}, "v": {"w": g(d, kvd)},
         "o": {"w": g(qd, d)}, "ln2": ln(), "fc1": {"w": g(d, i)}, "fc2": {"w": g(i, d)},
         "scale_attn": ls(), "scale_mlp": ls()}
        for _ in range(cfg.num_hidden_layers)
    ]}
    embed = g(cfg.num_quantizers, cfg.codebook_size, cfg.codebook_dim, scale=1.0)
    ns = cfg.num_semantic_quantizers
    out_sem, out_ac = g(cfg.codebook_dim, d), g(cfg.codebook_dim, d)
    dec_embed = np.concatenate([embed[:ns] @ out_sem, embed[ns:] @ out_ac], axis=0)
    us = upsample_spec(cfg)
    return {
        "quantizer": {"dec_embed": dec_embed.astype(np.float32)},
        "upsample": {"w": g(us["k"], us["in"] // us["groups"], us["out"])},
        "dec_tf": dec_tf,
        "decoder": decoder,
    }


def fill_zero_inits(sopro, mimi, seed: int, scale: float = 0.3) -> None:
    """Replace the zero-initialised leaves with random nonzero values, in
    place, so a comparison really exercises them: cross-attention gates,
    the FiLM output layer, the NAR adapter output, head-id offsets and
    mixes, the NAR previous-codebook weights (Sopro tree), and the Mimi
    decoder's conv biases (Mimi tree). Either tree may be None."""
    rng = np.random.default_rng(seed)
    rnd = lambda a: (rng.standard_normal(np.shape(a)) * scale).astype(np.float32)
    if sopro is not None:
        _fill_sopro(sopro, rnd)
    if mimi is not None:
        _fill_biases(mimi["decoder"], rnd)


def _fill_sopro(sopro: Tree, rnd) -> None:
    for xp in list(sopro["ar"]["xattn"]) + list(sopro["ref_xattn"]):
        if xp is not None:
            xp["gate"] = rnd(xp["gate"])
    for p in (sopro["spk_film"]["mlp2"], sopro["nar"]["adapter"]["mlp2"]):
        p["w"], p["b"] = rnd(p["w"]) * 0.1, rnd(p["b"])
    for s in sopro["nar"]["head_id_emb"]:
        sopro["nar"]["head_id_emb"][s]["emb"] = rnd(sopro["nar"]["head_id_emb"][s]["emb"])
        sopro["nar"]["mix"][s] = rnd(sopro["nar"]["mix"][s])
    sopro["nar_prev_cb_weights"] = rnd(sopro["nar_prev_cb_weights"])


def _fill_biases(p, rnd) -> None:
    if isinstance(p, dict):
        for k, v in p.items():
            if k == "b":
                p[k] = rnd(v) * 0.1
            else:
                _fill_biases(v, rnd)
    elif isinstance(p, list):
        for v in p:
            _fill_biases(v, rnd)
