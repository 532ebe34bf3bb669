"""CSM's depth decoder over one frame: kernel K6 and its plain version.

A frame's depth work, after the backbone's last hidden state h [1, D] and
codebook 0's code c0 [1]: Q - 1 passes of the depth decoder over its cache,
started afresh (pass 1 over positions 0 and 1, h and codebook 0's
embedding; pass p over position p, codebook p - 1's embedding), each
projected from the backbone's width and read out through codebook p's
head, and each followed by its decision. `csm_depth` runs it: CUDA tensors
through `csrc/csm_depth.cu` (K6, one persistent launch a frame), CPU
tensors through `depth_plain` (the eager passes of `models/csm.py` and
`sampling.sample_topk`, the kernel's plain version).

Decisions. With Gumbel noise [Q, V], codebook p's code is `sample_topk` of
its logits on noise row p; with forced codes [Q - 1] the passes take those
as their inputs instead (teacher forcing), and without noise the forced
codes are the frame's codes. `out` [Q] gets c0 and each pass's pick;
`logits` [Q - 1, V], where given, each pass's logits.

Widths K6 takes (`widths_problem`; the kernel refuses the same): float32
weights; every row length it multiplies (the backbone's and the depth
decoder's hidden sizes, the intermediate size, heads x head_dim) a multiple
of 4 floats for its 16-byte loads, at least 32, and at most 512 floats or a
multiple of 512 up to 8,192 (a row is one unit of a warp or whole units of
one 32 KB ring slot); the depth hidden size at most 2,048 (its norms hold a
row in registers); head_dim a multiple of 4; at most 8 layers; 2 <= Q <=
the depth cache's positions, and at most 64; V <= 4,096 (the sampler holds
the logits in registers); the block's shared memory (`smem_bytes`) within
the H100's 232,448 bytes; and a card of at least 32 SMs, which the kernel
checks. Top-k: any k >= 1 (the radix select has no cap; k past V keeps the
whole vocabulary, as `sample_topk` does). CSM-1B's widths take 227,904
bytes a block.

K6 reads every weight as the model holds it: the linears in [out, in],
the heads as rows [Q - 1, V, d] (`models/csm.py`).
"""

from __future__ import annotations

import ctypes
from functools import partial
from typing import Callable, Optional

import torch

from sopro_tpu_torch import kernels
from sopro_tpu_torch import sampling as S

STAGE, SEG, RING, WARPS = 8192, 512, 4, 16  # csm_depth.cu: kStage, kSeg, kRing, kWarps
RESV, MAX_LAYERS, MAX_POS, MAX_SMEM = 128, 8, 64, 232448
MAX_D, MAX_V = 2048, 4096  # kWarps / 2 * 32 * kNormPer, kVPer * kConsumers

_VP = ctypes.c_void_p
_need = partial(kernels.need, "csm_depth")  # (name, tensor, shape, dtype, device[, align])


class _Args(ctypes.Structure):
    """`CsmDepthArgs` in csm_depth.cu, field for field."""

    _fields_ = ([(n, ctypes.c_int) for n in ("D", "d", "F", "H", "KVH", "hd", "L", "V", "Q", "P", "top_k")]
                + [("eps", ctypes.c_float), ("temperature", ctypes.c_float)]
                + [(n, _VP) for n in ("proj", "norm", "heads", "audio_embed", "cos", "sin", "cache_k",
                                      "cache_v")]
                + [(n, _VP * MAX_LAYERS) for n in ("ln1", "ln2", "qkv", "o", "gate_up", "down")]
                + [(n, _VP) for n in ("h", "c0", "noise", "forced", "codes", "logits", "work")])


def _widths(cfg):
    d = cfg.depth
    return dict(D=cfg.backbone.hidden_size, d=d.hidden_size, F=d.intermediate_size,
                H=d.num_attention_heads, KVH=d.num_key_value_heads, hd=d.head_dim,
                L=d.num_hidden_layers, V=cfg.vocab_size, Q=cfg.num_codebooks,
                P=d.max_position_embeddings)


def smem_bytes(cfg) -> int:
    """Shared memory of a K6 block at these widths (csm_depth.cu
    `smem_bytes`): the ring, the activation area, each slot's unit partials
    and counts, the residual values, the reduction slots, the sampler's
    histograms and the mbarriers."""
    w = _widths(cfg)
    qkv = (w["H"] + 2 * w["KVH"]) * w["hd"]
    attn = (2 * w["H"] * w["hd"] + 2 * qkv + w["KVH"] * w["Q"] * (2 * w["hd"] + 4)
            + WARPS * MAX_POS)
    xs = (max(2 * w["D"], 2 * w["F"], attn) + 3) & ~3
    units = max(STAGE // k if k <= SEG else STAGE // SEG for k in (w["D"], w["d"], w["F"], w["H"] * w["hd"]))
    units = (units + 3) & ~3
    return 4 * (RING * STAGE + xs + RING * 3 * units + RESV + 64 + 1024) + 16 * RING


def work_floats(cfg) -> int:
    """K6's scratch a launch: the barrier counter (4 floats), the residual,
    q/k/v and SiLU(gate) * up for two positions, and the logits."""
    w = _widths(cfg)
    return 4 + 2 * w["d"] + 2 * (w["H"] + 2 * w["KVH"]) * w["hd"] + 2 * w["F"] + w["V"]


def _row_ok(k: int) -> bool:
    return k % 4 == 0 and k >= 32 and (k <= SEG or (k % SEG == 0 and k <= STAGE))


def widths_problem(cfg, top_k: int) -> Optional[str]:
    """Why K6 cannot take a CsmConfig at this top-k (module docstring), or
    None where it can."""
    w = _widths(cfg)
    if not 1 <= w["L"] <= MAX_LAYERS:
        return f"{w['L']} depth layers: K6 takes 1 to {MAX_LAYERS}"
    if not 2 <= w["Q"] <= min(w["P"], MAX_POS):
        return (f"{w['Q']} codebooks: K6 takes 2 up to the depth cache's {w['P']} positions, "
                f"and at most {MAX_POS}")
    if w["H"] % w["KVH"]:
        return f"{w['H']} heads over {w['KVH']} kv heads: not a whole group each"
    if w["hd"] < 4 or w["hd"] % 4:
        return f"head_dim {w['hd']}: K6 takes a multiple of 4 (16-byte loads)"
    rows = (("backbone hidden_size", w["D"]), ("depth hidden_size", w["d"]),
            ("depth intermediate_size", w["F"]), ("heads x head_dim", w["H"] * w["hd"]))
    for name, k in rows:
        if not _row_ok(k):
            return (f"{name} {k}: K6 takes rows of a multiple of 4 floats (16-byte loads), at "
                    f"least 32, and at most {SEG} or a multiple of {SEG} up to {STAGE}")
    if w["d"] > MAX_D:
        return f"depth hidden_size {w['d']}: K6's norms take at most {MAX_D}"
    if w["V"] > MAX_V:
        return f"vocab_size {w['V']}: K6's sampler takes at most {MAX_V}"
    if top_k < 1:
        return f"top_k {top_k}: K6 takes k >= 1"
    if smem_bytes(cfg) > MAX_SMEM:
        return f"{smem_bytes(cfg)} bytes of shared memory a block: over the H100's {MAX_SMEM}"
    return None


def check_widths(cfg, top_k: int) -> None:
    """Raise ValueError where K6 cannot take these widths (`widths_problem`)."""
    why = widths_problem(cfg, top_k)
    if why is not None:
        raise ValueError(f"csm_depth: {why}")


def depth_plain(model, cache, h: torch.Tensor, c: torch.Tensor,
                pick: Callable[[int, torch.Tensor], torch.Tensor], out: torch.Tensor) -> None:
    """One frame's depth passes as eager PyTorch ops after the backbone's
    last hidden state h [1, D] and codebook 0's code c [1]: `pick(i, logits
    [1, V])` gives codebook i's code, which feeds the next pass; the
    frame's codes go to `out` [Q]."""
    frame = [c]
    cache.reset()
    x = torch.cat([h, model.depth_input(0, c)])
    for i in range(1, model.cfg.num_codebooks):
        c = pick(i, model.codebook_logits(i, model.depth(x, cache)))
        frame.append(c)
        x = model.depth_input(i, c)
    torch.cat(frame, out=out)


class DepthKernel:
    """K6's launch for one CSM model and its depth cache on a CUDA device:
    the weights, the depth RoPE tables and the cache bound once (make it
    once per model and cache); per frame the inputs, the outputs and the scratch (from the caching
    allocator on the current stream)."""

    def __init__(self, model, cache):
        cfg, dev = model.cfg, model.device()
        if dev.type != "cuda":
            raise ValueError(f"csm_depth: K6 runs on a CUDA device, not {dev}")
        w = _widths(cfg)
        check_widths(cfg, 1)
        f32, p, dp = torch.float32, model.p, model.p["depth"]
        rope = model.ropes()[1]
        self.cfg, self.device, self.cache = cfg, dev, cache
        d, D, F, hd = w["d"], w["D"], w["F"], w["hd"]
        qkv = (w["H"] + 2 * w["KVH"]) * hd
        fixed = [("proj", dp["proj"], (d, D)), ("norm", dp["norm"], (d,)),
                 ("heads", p["heads"], (w["Q"] - 1, w["V"], d)),
                 ("audio_embed", p["audio_embed"], (w["Q"] * w["V"], D)),
                 ("cos", rope.cos, (w["P"], hd)), ("sin", rope.sin, (w["P"], hd)),
                 ("cache_k", cache.k, (w["L"], w["KVH"], w["P"], hd)),
                 ("cache_v", cache.v, (w["L"], w["KVH"], w["P"], hd))]
        layers = [("ln1", (d,)), ("ln2", (d,)), ("qkv", (qkv, d)), ("o", (d, w["H"] * hd)),
                  ("gate_up", (2 * F, d)), ("down", (d, F))]
        a = _Args(**w, top_k=1, eps=cfg.depth.rms_norm_eps, temperature=1.0)
        for name, x, shape in fixed:
            _need(name, x, shape, f32, dev)
            setattr(a, name, x.data_ptr())
        for name, shape in layers:
            for i, lp in enumerate(dp["layers"]):
                _need(f"layer {i} {name}", lp[name], shape, f32, dev)
                getattr(a, name)[i] = lp[name].data_ptr()
        self._args, self._work = a, work_floats(cfg)
        smem = kernels.entry("csm_depth", "sopro_csm_depth_smem", [_VP])
        smem.restype = ctypes.c_longlong
        if smem(ctypes.byref(a)) != smem_bytes(cfg):  # the two sides of one formula
            raise RuntimeError(f"csm_depth: smem_bytes {smem_bytes(cfg)} != the kernel's "
                               f"{smem(ctypes.byref(a))}")

    def __call__(self, h: torch.Tensor, c0: torch.Tensor, out: torch.Tensor, *,
                 noise: Optional[torch.Tensor] = None, temperature: float = 1.0, top_k: int = 50,
                 forced: Optional[torch.Tensor] = None, logits: Optional[torch.Tensor] = None) -> None:
        cfg, dev, i64, f32 = self.cfg, self.device, torch.int64, torch.float32
        q, v = cfg.num_codebooks, cfg.vocab_size
        check_widths(cfg, top_k)
        if noise is None and forced is None:
            raise ValueError("csm_depth: give the frame's noise, its forced codes, or both")
        if noise is not None and not temperature > 0:
            raise ValueError(f"csm_depth: temperature {temperature} must be > 0")
        _need("h", h, (1, cfg.backbone.hidden_size), f32, dev)
        _need("c0", c0, (1,), i64, dev, 8)
        _need("out", out, (q,), i64, dev, 8)
        a = self._args
        a.h, a.c0, a.codes = h.data_ptr(), c0.data_ptr(), out.data_ptr()
        a.noise = a.forced = a.logits = None
        if noise is not None:
            _need("noise", noise, (q, v), f32, dev, 4)
            a.noise = noise.data_ptr()
        if forced is not None:
            _need("forced", forced, (q - 1,), i64, dev, 8)
            if not bool(((forced >= 0) & (forced < v)).all()):
                raise ValueError(f"csm_depth: forced codes outside 0..{v - 1}")
            a.forced = forced.data_ptr()
        if logits is not None:
            _need("logits", logits, (q - 1, v), f32, dev, 4)
            a.logits = logits.data_ptr()
        a.temperature, a.top_k = float(temperature), int(top_k)
        work = torch.empty((self._work,), dtype=f32, device=dev)
        a.work = work.data_ptr()
        fn = kernels.entry("csm_depth", "sopro_csm_depth", [_VP, _VP])
        with kernels.on_device(dev) as stream:
            rc = fn(ctypes.byref(a), stream)
        kernels.check(rc, "csm_depth")
        kernels.count("csm_depth", f32)
        self.cache.filled = q  # positions 0..Q-1, as the eager passes leave it


def csm_depth(model, cache, h: torch.Tensor, c0: torch.Tensor, out: torch.Tensor, *,
              noise: Optional[torch.Tensor] = None, temperature: float = 1.0, top_k: int = 50,
              forced: Optional[torch.Tensor] = None, logits: Optional[torch.Tensor] = None,
              kernel: Optional[DepthKernel] = None) -> None:
    """One frame's depth passes and decisions (module docstring): K6 for
    CUDA tensors (`kernel`, the model's and cache's `DepthKernel`),
    `depth_plain` with `sampling.sample_topk` for CPU tensors."""
    if h.device.type == "cuda":
        if kernel is None:
            raise ValueError("csm_depth: CUDA tensors need `kernel`, a DepthKernel made once per "
                             "model and cache")
        kernel(h, c0, out, noise=noise, temperature=temperature, top_k=top_k, forced=forced,
               logits=logits)
        return
    if h.device.type != "cpu":
        raise ValueError(f"csm_depth: unsupported device {h.device}")
    if noise is None and forced is None:
        raise ValueError("csm_depth: give the frame's noise, its forced codes, or both")
    picks = []

    def pick(i, x):
        if logits is not None:
            logits[i - 1] = x[0]
        tok = forced[i - 1: i] if noise is None else S.sample_topk(x, noise[i: i + 1], temperature, top_k)
        picks.append(tok)
        return tok if forced is None else forced[i - 1: i]
    depth_plain(model, cache, h, c0, pick, out)
    if forced is not None:
        torch.cat([c0] + picks, out=out)
