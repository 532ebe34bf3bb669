"""CSM's backbone step over one frame: kernel K7 and its plain version.

A frame f >= 1 starts with one backbone step: the sum of the audio-table
rows of frame f - 1's codes [Q] as the input, the backbone's decoder layers
at the cache's next position (its keys and values written, `filled`
advanced), the final norm (h [1, D], which the depth passes start from),
codebook 0's head (`lm_head`) and its decision. `csm_backbone` runs it:
CUDA tensors through `csrc/csm_backbone.cu` (K7, one persistent launch),
CPU tensors through `step_plain` (`CsmModel.embed_frame`, `backbone` and
`codebook0_logits` of `models/csm.py` with `sampling.sample_topk`, the
kernel's plain version).

Decisions. With codebook 0's Gumbel noise [V], c0 is `sample_topk` of the
logits on it; with a forced code [1], c0 is that code (teacher forcing).
`logits` [V], where given, gets the logits.

Widths K7 takes (`widths_problem`; the kernel refuses the same): float32
weights; the backbone's hidden size, intermediate size and heads x head_dim
each a multiple of 4 floats, at least 32, and at most 512 or a multiple of
512 up to 8,192 (a row is one unit of a warp or whole units of one 32 KB
ring slot); the hidden size at most 4,096 (its norms hold a row in
registers); head_dim a multiple of 4 up to 64 (a lane combines two dims
of a head); 1 to 32 layers; 1 to 64 codebooks; V <= 4,096 (the sampler
holds the logits in registers); at most 32 attention chunks of 4,096 /
head_dim positions over the cache (2,048 positions at head_dim 64; a lane
of the combine holds one chunk); the block's shared memory (`smem_bytes`)
within the H100's 232,448 bytes. Top-k: any k >= 1. CSM-1B's widths take
221,432 bytes a block.

K7 reads every weight as the model holds it, the linears in [out, in].
"""

from __future__ import annotations

import ctypes
from functools import partial
from typing import Optional

import torch

from sopro_tpu_torch import kernels
from sopro_tpu_torch import sampling as S

STAGE, SEG, RING, MAX_Q = 8192, 512, 5, 64  # csm_backbone.cu: kStage, kSeg, kRing, kMaxQ
MAX_LAYERS, MAX_D, MAX_V, MAX_HD, MAX_SMEM = 32, 4096, 4096, 64, 232448
CHUNK_FLOATS, MAX_CHUNKS = 4096, 32  # kChunkFloats (an attention chunk's keys), kMaxChunks

_VP = ctypes.c_void_p
_need = partial(kernels.need, "csm_backbone")  # (name, tensor, shape, dtype, device[, align])


class _Args(ctypes.Structure):
    """`CsmBackboneArgs` in csm_backbone.cu, field for field."""

    _fields_ = ([(n, ctypes.c_int) for n in ("D", "F", "H", "KVH", "hd", "L", "V", "Q", "P", "pos",
                                              "top_k")]
                + [("eps", ctypes.c_float), ("temperature", ctypes.c_float)]
                + [(n, _VP) for n in ("audio_embed", "norm", "lm_head", "cos", "sin", "cache_k", "cache_v")]
                + [(n, _VP * MAX_LAYERS) for n in ("ln1", "ln2", "qkv", "o", "gate_up", "down")]
                + [(n, _VP) for n in ("prev", "noise", "forced", "h", "c0", "logits", "work")])


def _r4(n: int) -> int:
    return (n + 3) & ~3


def _widths(cfg, positions: int):
    b = cfg.backbone
    return dict(D=b.hidden_size, F=b.intermediate_size, H=b.num_attention_heads,
                KVH=b.num_key_value_heads, hd=b.head_dim, L=b.num_hidden_layers, V=cfg.vocab_size,
                Q=cfg.num_codebooks, P=int(positions))


def _chunks(w) -> int:
    """max_chunks: attention chunks of CHUNK_FLOATS / hd positions over the cache."""
    cp = CHUNK_FLOATS // w["hd"]
    return -(-w["P"] // cp)


def smem_bytes(cfg) -> int:
    """Shared memory of a K7 block at these widths (csm_backbone.cu
    `smem_bytes`): the ring, the activation area (the qkv input and the
    attention's scratch after it), the residual, each slot's unit partials
    and counts, the reduction slots, the sampler's histograms, the codes,
    the slots' claims and the mbarriers."""
    w = _widths(cfg, 1)
    cp, grp = CHUNK_FLOATS // w["hd"], w["H"] // w["KVH"]
    attn = _r4(w["D"]) + cp * (w["hd"] + 4) + cp * w["hd"] + grp * w["hd"] + grp * cp
    xs = _r4(max(w["F"], w["H"] * w["hd"], attn))
    units = _r4(max(STAGE // k if k <= SEG else STAGE // SEG for k in (w["D"], w["F"], w["H"] * w["hd"])))
    return 4 * (RING * STAGE + xs + _r4(w["D"]) + RING * 2 * units + 64 + 1024 + MAX_Q + 2 * RING) + 16 * RING


def work_floats(cfg, positions: int) -> int:
    """K7's scratch a launch: the counters, the residual's two buffers, q/k/v,
    SiLU(gate) * up, the logits and the attention partials."""
    w = _widths(cfg, positions)
    hc = w["H"] * _chunks(w)
    return (4 + _r4(4 * w["L"] + 1) + 2 * _r4(w["D"]) + _r4((w["H"] + 2 * w["KVH"]) * w["hd"])
            + _r4(w["F"]) + _r4(w["V"]) + hc * w["hd"] + 2 * _r4(hc))


def _row_ok(k: int) -> bool:
    return k % 4 == 0 and k >= 32 and (k <= SEG or (k % SEG == 0 and k <= STAGE))


def widths_problem(cfg, top_k: int, positions: Optional[int] = None) -> Optional[str]:
    """Why K7 cannot take a CsmConfig at this top-k over a cache of
    `positions` (default: the backbone's max_position_embeddings; module
    docstring), or None where it can."""
    positions = cfg.backbone.max_position_embeddings if positions is None else positions
    w = _widths(cfg, positions)
    if not 1 <= w["L"] <= MAX_LAYERS:
        return f"{w['L']} backbone layers: K7 takes 1 to {MAX_LAYERS}"
    if not 1 <= w["Q"] <= MAX_Q:
        return f"{w['Q']} codebooks: K7 takes 1 to {MAX_Q}"
    if w["H"] % w["KVH"]:
        return f"{w['H']} heads over {w['KVH']} kv heads: not a whole group each"
    if w["hd"] < 4 or w["hd"] % 4 or w["hd"] > MAX_HD:
        return f"head_dim {w['hd']}: K7 takes a multiple of 4 (16-byte loads) up to {MAX_HD}"
    rows = (("backbone hidden_size", w["D"]), ("backbone intermediate_size", w["F"]),
            ("heads x head_dim", w["H"] * w["hd"]))
    for name, k in rows:
        if not _row_ok(k):
            return (f"{name} {k}: K7 takes rows of a multiple of 4 floats (16-byte loads), at "
                    f"least 32, and at most {SEG} or a multiple of {SEG} up to {STAGE}")
    if w["D"] > MAX_D:
        return f"backbone hidden_size {w['D']}: K7's norms take at most {MAX_D}"
    if w["V"] > MAX_V:
        return f"vocab_size {w['V']}: K7's sampler takes at most {MAX_V}"
    if top_k < 1:
        return f"top_k {top_k}: K7 takes k >= 1"
    if not 1 <= _chunks(w) <= MAX_CHUNKS:
        return (f"a cache of {positions} positions: K7 takes 1 to {MAX_CHUNKS * CHUNK_FLOATS // w['hd']} "
                f"at head_dim {w['hd']}")
    if smem_bytes(cfg) > MAX_SMEM:
        return f"{smem_bytes(cfg)} bytes of shared memory a block: over the H100's {MAX_SMEM}"
    return None


def check_widths(cfg, top_k: int, positions: Optional[int] = None) -> None:
    """Raise ValueError where K7 cannot take these widths (`widths_problem`)."""
    why = widths_problem(cfg, top_k, positions)
    if why is not None:
        raise ValueError(f"csm_backbone: {why}")


def step_plain(model, cache, prev: torch.Tensor, h: torch.Tensor, c0: torch.Tensor, *,
               noise: Optional[torch.Tensor] = None, temperature: float = 1.0, top_k: int = 50,
               forced: Optional[torch.Tensor] = None, logits: Optional[torch.Tensor] = None) -> None:
    """One backbone step as eager PyTorch ops: frame f - 1's codes `prev`
    [Q] in, the final norm's output into h [1, D], codebook 0's code into c0
    [1] (`sample_topk` on `noise` [V], or `forced` [1]), the logits into
    `logits` [V] where given; the cache advances one position."""
    x = model.backbone(model.embed_frame(prev), cache)
    lg = model.codebook0_logits(x)
    h.copy_(x)
    c0.copy_(forced if forced is not None else S.sample_topk(lg, noise[None], temperature, top_k))
    if logits is not None:
        logits.copy_(lg[0])


class BackboneKernel:
    """K7's launch for one CSM model and its backbone cache on a CUDA
    device: the weights, the backbone's RoPE tables and the cache bound
    once (make it once per model and cache); per step the inputs, the
    outputs and the scratch (from the caching allocator on the current
    stream)."""

    def __init__(self, model, cache):
        cfg, dev = model.cfg, model.device()
        if dev.type != "cuda":
            raise ValueError(f"csm_backbone: K7 runs on a CUDA device, not {dev}")
        w = _widths(cfg, cache.length)
        check_widths(cfg, 1, cache.length)
        f32, p, bp = torch.float32, model.p, model.p["backbone"]
        rope = model.ropes()[0]
        if rope.cos.shape[0] < cache.length:
            raise ValueError(f"csm_backbone: RoPE tables of {rope.cos.shape[0]} positions for a cache "
                             f"of {cache.length}")
        self.cfg, self.device, self.cache = cfg, dev, cache
        D, F, hd = w["D"], w["F"], w["hd"]
        qkv = (w["H"] + 2 * w["KVH"]) * hd
        fixed = [("audio_embed", p["audio_embed"], (w["Q"] * w["V"], D)), ("norm", bp["norm"], (D,)),
                 ("lm_head", p["lm_head"], (w["V"], D)),
                 ("cos", rope.cos, tuple(rope.cos.shape)), ("sin", rope.sin, tuple(rope.cos.shape)),
                 ("cache_k", cache.k, (w["L"], w["KVH"], w["P"], hd)),
                 ("cache_v", cache.v, (w["L"], w["KVH"], w["P"], hd))]
        layers = [("ln1", (D,)), ("ln2", (D,)), ("qkv", (qkv, D)), ("o", (D, w["H"] * hd)),
                  ("gate_up", (2 * F, D)), ("down", (D, F))]
        a = _Args(**w, pos=0, top_k=1, eps=cfg.backbone.rms_norm_eps, temperature=1.0)
        for name, x, shape in fixed:
            _need(name, x, shape, f32, dev)
            setattr(a, name, x.data_ptr())
        for name, shape in layers:
            for i, lp in enumerate(bp["layers"]):
                _need(f"layer {i} {name}", lp[name], shape, f32, dev)
                getattr(a, name)[i] = lp[name].data_ptr()
        self._args, self._work = a, work_floats(cfg, cache.length)
        for entry, want in (("sopro_csm_backbone_smem", smem_bytes(cfg)),
                            ("sopro_csm_backbone_work", self._work)):
            fn = kernels.entry("csm_backbone", entry, [_VP])
            fn.restype = ctypes.c_longlong
            if fn(ctypes.byref(a)) != want:  # the two sides of one formula
                raise RuntimeError(f"csm_backbone: {entry} {fn(ctypes.byref(a))} != {want}")

    def __call__(self, prev: torch.Tensor, h: torch.Tensor, c0: torch.Tensor, *,
                 noise: Optional[torch.Tensor] = None, temperature: float = 1.0, top_k: int = 50,
                 forced: Optional[torch.Tensor] = None, logits: Optional[torch.Tensor] = None) -> None:
        cfg, dev, cache, i64, f32 = self.cfg, self.device, self.cache, torch.int64, torch.float32
        v = cfg.vocab_size
        check_widths(cfg, top_k, cache.length)
        _check_decision(noise, forced, temperature)
        if cache.filled >= cache.length:
            raise ValueError(f"csm_backbone: {cache.filled + 1} positions past the cache's {cache.length}")
        _need("prev", prev, (cfg.num_codebooks,), i64, dev, 8)
        _need("h", h, (1, cfg.backbone.hidden_size), f32, dev)
        _need("c0", c0, (1,), i64, dev, 8)
        a = self._args
        a.prev, a.h, a.c0 = prev.data_ptr(), h.data_ptr(), c0.data_ptr()
        a.noise = a.forced = a.logits = None
        if noise is not None:
            _need("noise", noise, (v,), f32, dev, 4)
            a.noise = noise.data_ptr()
        else:
            _need("forced", forced, (1,), i64, dev, 8)
            if not bool(((forced >= 0) & (forced < v)).all()):
                raise ValueError(f"csm_backbone: a forced code outside 0..{v - 1}")
            a.forced = forced.data_ptr()
        if logits is not None:
            _need("logits", logits, (v,), f32, dev, 4)
            a.logits = logits.data_ptr()
        a.pos, a.temperature, a.top_k = cache.filled, float(temperature), int(top_k)
        work = torch.empty((self._work,), dtype=f32, device=dev)
        a.work = work.data_ptr()
        fn = kernels.entry("csm_backbone", "sopro_csm_backbone", [_VP, _VP])
        with kernels.on_device(dev) as stream:
            rc = fn(ctypes.byref(a), stream)
        kernels.check(rc, "csm_backbone")
        kernels.count("csm_backbone", f32)
        cache.filled += 1


def _check_decision(noise, forced, temperature) -> None:
    if (noise is None) == (forced is None):
        raise ValueError("csm_backbone: give codebook 0's noise or its forced code, one of the two")
    if noise is not None and not temperature > 0:
        raise ValueError(f"csm_backbone: temperature {temperature} must be > 0")


def csm_backbone(model, cache, prev: torch.Tensor, h: torch.Tensor, c0: torch.Tensor, *,
                 noise: Optional[torch.Tensor] = None, temperature: float = 1.0, top_k: int = 50,
                 forced: Optional[torch.Tensor] = None, logits: Optional[torch.Tensor] = None,
                 kernel: Optional[BackboneKernel] = None) -> None:
    """One backbone step and codebook 0's decision (module docstring): K7 for
    CUDA tensors (`kernel`, the model's and cache's `BackboneKernel`),
    `step_plain` for CPU tensors."""
    if h.device.type == "cuda":
        if kernel is None:
            raise ValueError("csm_backbone: CUDA tensors need `kernel`, a BackboneKernel made once per "
                             "model and cache")
        kernel(prev, h, c0, noise=noise, temperature=temperature, top_k=top_k, forced=forced,
               logits=logits)
        return
    if h.device.type != "cpu":
        raise ValueError(f"csm_backbone: unsupported device {h.device}")
    _check_decision(noise, forced, temperature)
    step_plain(model, cache, prev, h, c0, noise=noise, temperature=temperature, top_k=top_k,
               forced=forced, logits=logits)
