"""The AR decode loop, state in -> state out: kernel K1 and its plain version.

Replaces sopro_tpu/ops/pallas_ar_loop.py::ar_loop_pallas. `ar_loop` runs
`n_steps` decode steps for B rows from an arbitrary state: CUDA tensors go
through the hand-written kernel `csrc/ar_loop.cu` (every step inside one
launch); CPU tensors go through `ar_loop_plain`, the same steps as plain
PyTorch ops with the semantics of the JAX package's `ar_single_step`.
`ar_loop_step` is that step; it takes the block stack from its context
(`ctx.step`), so the per-step kernel K5 (`ops/ar_step.py`, the same source
in its logits-only mode) shares its sampler and per-row freeze.

State: {t, last, streak, stopped, first_eos: int32 [B]; key: int64 [B, 2]
holding uint32 words; hist: int32 [B, HIST_LEN]; bufs: [N, B, CTX, D] in the
weights' dtype}. Settings: {top_p, temperature, recovery_top_p,
recovery_temp: f32 [B]; min_gen: int32 [B]}. Returns (tokens int32 [B,
n_steps], new state); a column past a row's stop holds 0.

The weights, the conditioning, the previous-token table, the text KV and
the ring buffers are float32, or all bfloat16 under the bf16 compute
policy: bfloat16 CUDA tensors launch the kernels' bfloat16 instantiations
(`sopro_ar_loop_bf16`, `sopro_ar_step_bf16`), whose weight stream is
packed in bfloat16; the plain step (`models/generator.py::ar_step`) rounds
where they do. The logits and the sampler stay float32.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from sopro_tpu_torch import kernels
from sopro_tpu_torch import sampling as S
from sopro_tpu_torch.config import SoproTTSConfig
from sopro_tpu_torch.models.generator import TEXT_HEADS, ar_step, conv_ctx

STATE_KEYS = ("t", "last", "streak", "stopped", "first_eos", "key", "hist", "bufs")
LOOP_STREAK = 8
TOP_K = 50
REP_PENALTY = 1.1


@dataclass
class ARLoopContext:
    """What every step reads besides the state: the AR parameter tree and
    its stacked kernel view, the fixed text KV, the compact previous-token
    table [V+1, D] (rows 0..V-1: codebook-1 embeddings, row V: BOS), and on
    CUDA the kernel's packed weight stream per cluster size. `kv_k` / `kv_v`
    [A, B, H, L, hd], when given, are the text KV already stacked as the
    kernel reads it (`kv` then holds views of them); else each launch
    stacks `kv`."""

    cfg: SoproTTSConfig
    p_ar: Dict
    stacked: Optional[Dict[str, torch.Tensor]]
    kv: List[Optional[Dict]]
    mask: torch.Tensor  # [B, L] bool
    emb: torch.Tensor  # [V+1, D]
    stream: Optional[Callable[[int], Dict]] = None  # cluster size -> packed weights (CUDA)
    kv_k: Optional[torch.Tensor] = None
    kv_v: Optional[torch.Tensor] = None

    def step(self, x: torch.Tensor, bufs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The block stack of one step as plain PyTorch ops."""
        return ar_step(self.p_ar, self.cfg, x, bufs, self.kv)


def ar_loop_step(
    ctx,
    cond: torch.Tensor,
    st: Dict[str, torch.Tensor],
    settings: Dict[str, torch.Tensor],
    anti_loop: bool,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """One frame for every row -> (tok [B], active [B], new state). Inactive
    rows (stopped, or t at the cond length) keep their state. `ctx` is an
    ARLoopContext or an ARStepContext: its `cfg`, `emb` and `step(x, bufs)
    -> (logits, bufs)` are read."""
    cfg = ctx.cfg
    b, s_max = cond.shape[0], cond.shape[1]
    v = int(cfg.ar_vocab)
    t = st["t"]
    active = (t < s_max) & (st["stopped"] == 0)
    rows = torch.arange(b, device=cond.device)
    prev = torch.where(t == 0, torch.full_like(t, v), st["last"])
    x = cond[rows, torch.clamp(t, max=s_max - 1).long()] + ctx.emb[prev.long()]

    top_p, temp = S.anti_loop_settings(
        st["hist"], t, st["streak"],
        base=(settings["top_p"], settings["temperature"]),
        recovery=(settings["recovery_top_p"], settings["recovery_temp"]),
        loop_streak=LOOP_STREAK, enabled=anti_loop,
    )
    logits, bufs = ctx.step(x, st["bufs"])
    key, sub = S.split_keys(st["key"])
    tok = S.sample_full_vocab(
        sub[:, 0:1], sub[:, 1:2], logits.float(), S.history_member(st["hist"], v),
        top_p[:, None], temp[:, None], top_k=TOP_K, repetition_penalty=REP_PENALTY,
    )[:, 0].to(torch.int32)

    streak, last = S.update_streak(st["streak"], st["last"], tok, t)
    is_eos = tok == int(cfg.eos_id)
    new = {
        "t": torch.where(active, t + 1, t),
        "last": torch.where(active, last, st["last"]),
        "streak": torch.where(active, streak, st["streak"]),
        "stopped": torch.where(
            active & is_eos & (t + 1 >= settings["min_gen"]),
            torch.ones_like(st["stopped"]), st["stopped"],
        ),
        "first_eos": torch.where(
            active & is_eos & (st["first_eos"] >= s_max), t, st["first_eos"]
        ),
        "key": torch.where(active[:, None], key, st["key"]),
        "hist": torch.where(active[:, None], S.push_history(st["hist"], tok), st["hist"]),
        "bufs": torch.where(active[None, :, None, None], bufs, st["bufs"]),
    }
    return tok, active, new


def ar_loop_plain(
    ctx: ARLoopContext,
    cond: torch.Tensor,
    state: Dict[str, torch.Tensor],
    settings: Dict[str, torch.Tensor],
    n_steps: int,
    anti_loop: bool,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain PyTorch version of the loop kernel (same contract)."""
    st = dict(state)
    tokens = torch.zeros((cond.shape[0], int(n_steps)), dtype=torch.int32, device=cond.device)
    for i in range(int(n_steps)):
        tok, active, st = ar_loop_step(ctx, cond, st, settings, anti_loop)
        if not bool(active.any()):
            break
        tokens[:, i] = torch.where(active, tok, torch.zeros_like(tok))
    return tokens, st


def ar_loop(
    ctx: ARLoopContext,
    cond: torch.Tensor,
    state: Dict[str, torch.Tensor],
    settings: Dict[str, torch.Tensor],
    n_steps: int,
    anti_loop: bool,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run `n_steps` decode steps: the kernel on a CUDA device, the plain
    version on the CPU."""
    if cond.device.type == "cpu":
        return ar_loop_plain(ctx, cond, state, settings, n_steps, anti_loop)
    if cond.device.type != "cuda":
        raise ValueError(f"ar_loop: unsupported device {cond.device}")
    return _ar_loop_cuda(ctx, cond, state, settings, n_steps, anti_loop)


# --------------------------------------------------------------------------
# kernel binding (shared with K5, ops/ar_step.py)
# --------------------------------------------------------------------------

MAX_LAYERS = 16
THREADS = 512  # kThreads in csrc/ar_loop.cu
RING, STAGE = 3, 8192  # kRing, kStage: the weight ring's stages, floats per stage
SMEM_PER_BLOCK = 232448  # 227 KB: the most shared memory a Hopper block can have
STREAM_DTYPES = (torch.float32, torch.bfloat16)


def _esize(dtype) -> int:
    """Bytes per element of the weight stream (4 or 2)."""
    if dtype not in STREAM_DTYPES:
        raise ValueError(f"the AR kernels take float32 or bfloat16 weights, not {dtype}")
    return torch.tensor([], dtype=dtype).element_size()


def _layout(cfg: SoproTTSConfig, cs: int, dtype=torch.float32) -> Tuple[int, int, int]:
    """(cw, fw, vw): channels, FFN columns and logits of one rank (vw a
    multiple of 16 bytes of `dtype`)."""
    d, v = int(cfg.d_model), int(cfg.ar_vocab)
    vp = v + (-v) % 4
    align = 16 // _esize(dtype)
    return d // cs, 4 * d // cs, ((vp + cs - 1) // cs + align - 1) // align * align


def _qualifies(cfg: SoproTTSConfig, cs: int, dtype=torch.float32) -> bool:
    """csrc/ar_loop.cu `configure`: cs divides D, the conv products fit the
    partial-sum buffer, every stream slice is a multiple of 16 bytes wide and
    fits a ring stage and the gemv's threads, and a buffer idle during the
    sampler holds the penalized logits."""
    d, k, v = int(cfg.d_model), int(cfg.ar_kernel), int(cfg.ar_vocab)
    if d % cs:
        return False
    cw, fw, vw = _layout(cfg, cs, dtype)
    esize = _esize(dtype)
    return (cw * k <= 4 * THREADS and not (cw | fw | vw | d) & (16 // esize - 1)
            and max(d, fw, vw) <= min(STAGE * 4 // esize, 4 * THREADS)
            and (cs * d >= v or v <= 4 * THREADS))


def stream_slices(cfg: SoproTTSConfig, cs: int, dtype=torch.float32) -> List[Tuple[str, int, int, int]]:
    """(name, layer or attention index, rows, width) of the weight slices a
    rank reads in one step, in order (csrc/ar_loop.cu `stream_schedule`):
    per layer its GLU columns (a then b), ff1 columns and ff2 rows, after
    every freq-th layer its x_q columns and x_out rows; then its head
    columns (zero past Vp)."""
    d, n, freq = int(cfg.d_model), int(cfg.n_layers_ar), int(cfg.ar_text_attn_freq)
    cw, fw, vw = _layout(cfg, cs, dtype)
    out = []
    for li in range(n):
        out += [("glu_w", li, d, 2 * cw), ("ff1_w", li, d, fw), ("ff2_w", li, fw, d)]
        if (li + 1) % freq == 0:
            out += [("x_q", li // freq, d, cw), ("x_out", li // freq, cw, d)]
    return out + [("head_w", 0, d, vw)]


def stream_schedule(
    cfg: SoproTTSConfig, cs: int, dtype=torch.float32
) -> Tuple[List[Tuple[int, int]], int]:
    """([(offset, elements)] per ring chunk of a step, elements per rank):
    each slice in chunks of whole rows that fill at most one 32 KB stage
    (STAGE floats, twice as many bfloat16 elements)."""
    chunks, off = [], 0
    stage = STAGE * 4 // _esize(dtype)
    for _, _, rows, width in stream_slices(cfg, cs, dtype):
        rpc = stage // width
        for r0 in range(0, rows, rpc):
            n = min(rpc, rows - r0) * width
            chunks.append((off, n))
            off += n
    return chunks, off


def _rank_slice(w: Dict[str, torch.Tensor], name: str, i: int, r: int, cfg, cs: int):
    d = int(cfg.d_model)
    cw, fw, vw = _layout(cfg, cs, w["head_w"].dtype)
    c0, f0 = r * cw, r * fw
    if name == "glu_w":
        return torch.cat([w[name][i][:, c0:c0 + cw], w[name][i][:, d + c0:d + c0 + cw]], 1)
    if name == "ff1_w":
        return w[name][i][:, f0:f0 + fw]
    if name == "ff2_w":
        return w[name][i][f0:f0 + fw]
    if name == "x_q":
        return w[name][i][:, c0:c0 + cw]
    if name == "x_out":
        return w[name][i][c0:c0 + cw]
    head = w["head_w"]  # [D, Vp]
    v0 = min(head.shape[1], r * vw)
    cols = head[:, v0:v0 + vw]
    return torch.nn.functional.pad(cols, (0, vw - cols.shape[1]))


def pack_ar_stream(w: Dict[str, torch.Tensor], cfg: SoproTTSConfig, cs: int) -> Dict:
    """The stacked weights (`ARGenerator.stacked()`) as K1/K5 stream them at
    cluster size cs: {"w": [cs, len] in the weights' dtype, rank r's slices
    back to back in `stream_slices` order, row-major; "len"; "cs"}."""
    slices = stream_slices(cfg, cs, w["head_w"].dtype)
    ranks = [torch.cat([_rank_slice(w, name, i, r, cfg, cs).reshape(-1)
                        for name, i, _, _ in slices]) for r in range(cs)]
    return {"w": torch.stack(ranks).contiguous(), "len": int(ranks[0].numel()), "cs": cs}


def smem_bytes(cfg: SoproTTSConfig, text_len: int, dtype=torch.float32) -> Optional[int]:
    """Shared memory per block that csrc/ar_loop.cu asks for at text length
    `text_len` for weights of `dtype`: a host mirror of its `smem_floats` /
    `smem_ints` at the first cluster size its launch tries (16, 8, ... that
    `_qualifies`). None when no cluster size qualifies. K1 and K5 take the
    same amount; the batch size and step count do not enter (one cluster per
    row, the steps loop inside)."""
    d, n, k, v = int(cfg.d_model), int(cfg.n_layers_ar), int(cfg.ar_kernel), int(cfg.ar_vocab)
    ctx = conv_ctx(cfg)
    for cs in (16, 8, 4, 2, 1):
        if not _qualifies(cfg, cs, dtype):
            continue
        cw, fw, vw = _layout(cfg, cs, dtype)
        mine = n * (ctx + 3 + k) * cw + n * fw
        floats = (32 + RING * STAGE + 7 * d + max(fw, vw) + cs * d + int(text_len) + 2 * v
                  + 4 * THREADS + mine + 64)
        ints = v + S.HIST_LEN + 64 + 16 + 2 * len(stream_schedule(cfg, cs, dtype)[0])
        return 4 * (floats + ints)
    return None


class _Args(ctypes.Structure):
    """Mirror of `ArLoopArgs` in csrc/ar_loop.cu (same field order)."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "B", "S", "n_steps", "L", "D", "N", "K", "CTX", "A", "H", "V", "Vp",
            "freq", "anti_loop", "eos", "hist_len", "top_k", "loop_streak",
        )]
        + [("dils", ctypes.c_int * MAX_LAYERS), ("rep_pen", ctypes.c_float)]
        + [(n, ctypes.c_void_p) for n in (
            "top_p", "temp", "rtp", "rtemp", "min_gen",
            "t_in", "last_in", "streak_in", "stopped_in", "feos_in", "key_in",
            "hist_in", "bufs_in", "cond", "emb",
            "norm", "glu_w", "glu_b", "dw_w", "dw_b", "ff_norm", "ff1_w",
            "ff1_b", "ff2_w", "ff2_b", "x_nq", "x_q", "x_out", "x_gate",
            "kv_k", "kv_v", "mask", "out_norm", "head_w", "head_b",
            "tokens", "t_out", "last_out", "streak_out", "stopped_out",
            "feos_out", "key_out", "hist_out", "bufs_out", "x_in", "logits", "wstream",
        )]
        + [("stream_len", ctypes.c_int), ("cs", ctypes.c_int)]
    )


WEIGHTS = ("norm", "glu_w", "glu_b", "dw_w", "dw_b", "ff_norm", "ff1_w", "ff1_b",
           "ff2_w", "ff2_b", "x_nq", "x_q", "x_out", "x_gate", "out_norm", "head_w", "head_b")


def need(kernel: str, t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{kernel}: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} is not contiguous")


def block_args(
    kernel: str, cfg: SoproTTSConfig, w: Dict[str, torch.Tensor], kv_k: torch.Tensor,
    kv_v: torch.Tensor, mask: torch.Tensor, bufs: torch.Tensor,
) -> _Args:
    """The fields K1 and K5 share, checked: sizes, dilations, the stacked
    weights, the text KV [A, B, H, L, hd], the int32 mask [B, L] and the
    ring buffers [N, B, CTX, D] going in, all in the weights' dtype
    (float32 or bfloat16)."""
    dev = bufs.device
    n, b, ctx_len, d = (int(x) for x in bufs.shape)
    k, v, freq = int(cfg.ar_kernel), int(cfg.ar_vocab), int(cfg.ar_text_attn_freq)
    vp = int(w["head_w"].shape[1])  # V padded to a multiple of 4
    a_n = int(w["x_q"].shape[0])
    l_txt = int(kv_k.shape[3])
    hd = d // TEXT_HEADS
    if n != int(cfg.n_layers_ar) or n > MAX_LAYERS or a_n != n // freq or vp % 4 or vp < v:
        raise ValueError(f"{kernel}: unsupported layer/attention layout")
    if ctx_len < conv_ctx(cfg):
        raise ValueError(f"{kernel}: conv buffer shorter than the receptive field")
    f32 = w["head_w"].dtype
    _esize(f32)
    checks = [
        (kv_k, "kv_k", f32, (a_n, b, TEXT_HEADS, l_txt, hd)),
        (kv_v, "kv_v", f32, (a_n, b, TEXT_HEADS, l_txt, hd)),
        (mask, "mask", torch.int32, (b, l_txt)), (bufs, "bufs", f32, (n, b, ctx_len, d)),
        (w["norm"], "norm", f32, (n, d)), (w["glu_w"], "glu_w", f32, (n, d, 2 * d)),
        (w["glu_b"], "glu_b", f32, (n, 2 * d)), (w["dw_w"], "dw_w", f32, (n, k, d)),
        (w["dw_b"], "dw_b", f32, (n, d)), (w["ff_norm"], "ff_norm", f32, (n, d)),
        (w["ff1_w"], "ff1_w", f32, (n, d, 4 * d)), (w["ff1_b"], "ff1_b", f32, (n, 4 * d)),
        (w["ff2_w"], "ff2_w", f32, (n, 4 * d, d)), (w["ff2_b"], "ff2_b", f32, (n, d)),
        (w["x_nq"], "x_nq", f32, (a_n, d)), (w["x_q"], "x_q", f32, (a_n, d, d)),
        (w["x_out"], "x_out", f32, (a_n, d, d)), (w["x_gate"], "x_gate", f32, (a_n,)),
        (w["out_norm"], "out_norm", f32, (d,)), (w["head_w"], "head_w", f32, (d, vp)),
        (w["head_b"], "head_b", f32, (vp,)),
    ]
    for t, name, dtype, shape in checks:
        need(kernel, t, name, dtype, shape, dev)

    args = _Args()
    for name, val in (
        ("B", b), ("L", l_txt), ("D", d), ("N", n), ("K", k), ("CTX", ctx_len), ("A", a_n),
        ("H", TEXT_HEADS), ("V", v), ("Vp", vp), ("freq", freq), ("eos", int(cfg.eos_id)),
        ("hist_len", S.HIST_LEN), ("top_k", TOP_K), ("loop_streak", LOOP_STREAK),
    ):
        setattr(args, name, val)
    for i, dil in enumerate(cfg.ar_dilations()):
        args.dils[i] = int(dil)
    args.rep_pen = REP_PENALTY
    for name, t in dict({name: w[name] for name in WEIGHTS},
                        kv_k=kv_k, kv_v=kv_v, mask=mask, bufs_in=bufs).items():
        setattr(args, name, t.data_ptr())
    return args


_ARGTYPES = {
    "sopro_ar_cluster": [ctypes.POINTER(_Args), ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
    "sopro_ar_active_clusters": [ctypes.POINTER(_Args), ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int)],
    "sopro_ar_loop": [ctypes.POINTER(_Args), ctypes.c_void_p],
    "sopro_ar_step": [ctypes.POINTER(_Args), ctypes.c_void_p],
}
_ARGTYPES.update({
    "sopro_ar_loop_bf16": _ARGTYPES["sopro_ar_loop"], "sopro_ar_step_bf16": _ARGTYPES["sopro_ar_step"],
})
_CLUSTER: Dict[tuple, int] = {}


def _mode(logits_only: bool, dtype) -> int:
    """csrc/ar_loop.cu's `mode`: bit 0 K5, bit 1 the bfloat16 instantiation."""
    return int(logits_only) | (2 if dtype == torch.bfloat16 else 0)


def cluster_size(args: _Args, logits_only: bool, dtype, device) -> int:
    """The cluster size csrc/ar_loop.cu takes for these shapes and weight
    dtype on CUDA `device` (the current device: call inside
    `kernels.on_device`), asked once per library, card model and shape:
    the weight stream is packed for it."""
    lib = kernels.lib("ar_loop")
    mode = _mode(logits_only, dtype)
    key = (id(lib), torch.cuda.get_device_name(device), mode) + tuple(
        getattr(args, f) for f in ("L", "D", "N", "K", "CTX", "H", "V", "freq", "hist_len"))
    if key not in _CLUSTER:
        cs = ctypes.c_int(0)
        fn = kernels.entry("ar_loop", "sopro_ar_cluster", _ARGTYPES["sopro_ar_cluster"])
        kernels.check(fn(ctypes.byref(args), mode, ctypes.byref(cs)), "ar_loop cluster")
        _CLUSTER[key] = cs.value
    return _CLUSTER[key]


def launch(kernel: str, entry: str, args: _Args, device, stream, dtype=torch.float32) -> None:
    """Call C entry point `entry` of csrc/ar_loop.cu (its `_bf16`
    instantiation for bfloat16 weights) on `device` and its current stream
    with the weight stream packed for its cluster size (`stream(cs)`,
    `ARGenerator.stream`), raise on a refused launch, count it under
    `kernel` and `dtype`."""
    if stream is None:
        raise ValueError(f"{kernel}: the context carries no weight stream (built on the CPU?)")
    with kernels.on_device(device) as cuda_stream:
        cs = cluster_size(args, entry == "sopro_ar_step", dtype, device)
        pack = stream(cs)
        if pack["w"].dtype != dtype:
            raise ValueError(f"{kernel}: the weight stream is {pack['w'].dtype}, the weights {dtype}")
        args.wstream, args.stream_len, args.cs = pack["w"].data_ptr(), pack["len"], cs
        name = entry + ("_bf16" if dtype == torch.bfloat16 else "")
        fn = kernels.entry("ar_loop", name, _ARGTYPES[name])
        kernels.check(fn(ctypes.byref(args), cuda_stream), kernel)
    kernels.count(kernel, dtype)
    kernels.LAUNCH_INFO[kernel] = {"cluster_blocks_per_row": cs}


def _loop_args(ctx, cond, state, settings, n_steps, anti_loop):
    """K1's checked arguments, its outputs (tokens [B, n_steps], the new
    state), allocated, and the temporaries the arguments point to (hold
    them until the launch is enqueued)."""
    dev = cond.device
    b, s_max, d = cond.shape
    v = int(ctx.cfg.ar_vocab)
    if ctx.kv_k is not None:
        kv_k, kv_v = ctx.kv_k, ctx.kv_v
    else:
        kv_k = torch.stack([c["k"] for c in ctx.kv if c is not None]).contiguous()
        kv_v = torch.stack([c["v"] for c in ctx.kv if c is not None]).contiguous()
    mask = ctx.mask.to(torch.int32).contiguous()
    args = block_args("ar_loop", ctx.cfg, ctx.stacked, kv_k, kv_v, mask, state["bufs"])

    i32, f32, wdt = torch.int32, torch.float32, ctx.stacked["head_w"].dtype
    checks = [(cond, "cond", wdt, (b, s_max, d)), (ctx.emb, "emb", wdt, (v + 1, d))]
    for name in ("t", "last", "streak", "stopped", "first_eos"):
        checks.append((state[name], name, i32, (b,)))
    checks += [
        (state["key"], "key", torch.int64, (b, 2)),
        (state["hist"], "hist", i32, (b, S.HIST_LEN)),
    ]
    for name in ("top_p", "temperature", "recovery_top_p", "recovery_temp"):
        checks.append((settings[name], name, f32, (b,)))
    checks.append((settings["min_gen"], "min_gen", i32, (b,)))
    for t, name, dtype, shape in checks:
        need("ar_loop", t, name, dtype, shape, dev)

    tokens = torch.empty((b, int(n_steps)), dtype=i32, device=dev)
    out = {name: torch.empty_like(state[name]) for name in STATE_KEYS}
    args.S, args.n_steps, args.anti_loop = s_max, int(n_steps), int(bool(anti_loop))
    bind = {
        "top_p": settings["top_p"], "temp": settings["temperature"],
        "rtp": settings["recovery_top_p"], "rtemp": settings["recovery_temp"],
        "min_gen": settings["min_gen"],
        "t_in": state["t"], "last_in": state["last"], "streak_in": state["streak"],
        "stopped_in": state["stopped"], "feos_in": state["first_eos"],
        "key_in": state["key"], "hist_in": state["hist"], "cond": cond, "emb": ctx.emb,
        "tokens": tokens, "t_out": out["t"], "last_out": out["last"],
        "streak_out": out["streak"], "stopped_out": out["stopped"],
        "feos_out": out["first_eos"], "key_out": out["key"],
        "hist_out": out["hist"], "bufs_out": out["bufs"],
    }
    for name, t in bind.items():
        setattr(args, name, t.data_ptr())
    return args, tokens, out, (kv_k, kv_v, mask)


def _ar_loop_cuda(ctx, cond, state, settings, n_steps, anti_loop):
    args, tokens, out, _keep = _loop_args(ctx, cond, state, settings, n_steps, anti_loop)
    launch("ar_loop", "sopro_ar_loop", args, cond.device, ctx.stream, cond.dtype)
    return tokens, out


def active_clusters(ctx: ARLoopContext, cond, state, settings) -> Tuple[int, int]:
    """(cluster size, clusters the card holds at once) of K1's launch for
    these shapes (`cudaOccupancyMaxActiveClusters`): a cluster must fit in
    one GPC, so rows past the count run in later waves. Launches nothing."""
    args, _, _, _keep = _loop_args(ctx, cond, state, settings, 1, True)
    with kernels.on_device(cond.device):
        cs = cluster_size(args, False, cond.dtype, cond.device)
        args.cs, n = cs, ctypes.c_int(0)
        fn = kernels.entry("ar_loop", "sopro_ar_active_clusters",
                           _ARGTYPES["sopro_ar_active_clusters"])
        kernels.check(fn(ctypes.byref(args), _mode(False, cond.dtype), ctypes.byref(n)),
                      "ar_loop active clusters")
    return cs, n.value
