"""The AR decode loop, state in -> state out: kernel K1 and its plain version.

Replaces sopro_tpu/ops/pallas_ar_loop.py::ar_loop_pallas. `ar_loop` runs
`n_steps` decode steps for B rows from an arbitrary state: CUDA tensors go
through the hand-written kernel `csrc/ar_loop.cu` (every step inside one
launch); CPU tensors go through `ar_loop_plain`, the same steps as plain
PyTorch ops with the semantics of the JAX package's `ar_single_step`.

State: {t, last, streak, stopped, first_eos: int32 [B]; key: int64 [B, 2]
holding uint32 words; hist: int32 [B, HIST_LEN]; bufs: f32 [N, B, CTX, D]}.
Settings: {top_p, temperature, recovery_top_p, recovery_temp: f32 [B];
min_gen: int32 [B]}. Returns (tokens int32 [B, n_steps], new state); a
column past a row's stop holds 0.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from sopro_tpu_torch import kernels
from sopro_tpu_torch import sampling as S
from sopro_tpu_torch.config import SoproTTSConfig
from sopro_tpu_torch.models.generator import TEXT_HEADS, ar_step

STATE_KEYS = ("t", "last", "streak", "stopped", "first_eos", "key", "hist", "bufs")
LOOP_STREAK = 8
TOP_K = 50
REP_PENALTY = 1.1


@dataclass
class ARLoopContext:
    """What every step reads besides the state: the AR parameter tree and
    its stacked kernel view, the fixed text KV, and the compact
    previous-token table [V+1, D] (rows 0..V-1: codebook-1 embeddings,
    row V: BOS)."""

    cfg: SoproTTSConfig
    p_ar: Dict
    stacked: Optional[Dict[str, torch.Tensor]]
    kv: List[Optional[Dict]]
    mask: torch.Tensor  # [B, L] bool
    emb: torch.Tensor  # [V+1, D]


def ar_loop_step(
    ctx: ARLoopContext,
    cond: torch.Tensor,
    st: Dict[str, torch.Tensor],
    settings: Dict[str, torch.Tensor],
    anti_loop: bool,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """One frame for every row -> (tok [B], active [B], new state). Inactive
    rows (stopped, or t at the cond length) keep their state."""
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
    logits, bufs = ar_step(ctx.p_ar, cfg, x, st["bufs"], ctx.kv)
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
# kernel binding
# --------------------------------------------------------------------------

MAX_LAYERS = 16


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
            "feos_out", "key_out", "hist_out", "bufs_out",
        )]
    )


def _need(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"ar_loop: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"ar_loop: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"ar_loop: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"ar_loop: {name} is not contiguous")


def _ar_loop_cuda(ctx, cond, state, settings, n_steps, anti_loop):
    cfg = ctx.cfg
    dev = cond.device
    b, s_max, d = cond.shape
    n, k = int(cfg.n_layers_ar), int(cfg.ar_kernel)
    v = int(cfg.ar_vocab)
    freq = int(cfg.ar_text_attn_freq)
    w = ctx.stacked
    vp = int(w["head_w"].shape[1])  # V padded to a multiple of 4
    a_n = int(w["x_q"].shape[0])
    kv_k = torch.stack([c["k"] for c in ctx.kv if c is not None]).contiguous()
    kv_v = torch.stack([c["v"] for c in ctx.kv if c is not None]).contiguous()
    l_txt = int(kv_k.shape[3])
    hd = d // TEXT_HEADS
    ctx_len = int(state["bufs"].shape[2])
    if n > MAX_LAYERS or a_n != n // freq or vp % 4 or vp < v:
        raise ValueError("ar_loop: unsupported layer/attention layout")
    if ctx_len < (k - 1) * max(cfg.ar_dilations()) + 1:
        raise ValueError("ar_loop: conv buffer shorter than the receptive field")
    mask = ctx.mask.to(torch.int32).contiguous()

    i32, f32 = torch.int32, torch.float32
    checks = [
        (cond, "cond", f32, (b, s_max, d)), (ctx.emb, "emb", f32, (v + 1, d)),
        (kv_k, "kv_k", f32, (a_n, b, TEXT_HEADS, l_txt, hd)),
        (kv_v, "kv_v", f32, (a_n, b, TEXT_HEADS, l_txt, hd)), (mask, "mask", i32, (b, l_txt)),
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
    for name in ("t", "last", "streak", "stopped", "first_eos"):
        checks.append((state[name], name, i32, (b,)))
    checks += [
        (state["key"], "key", torch.int64, (b, 2)),
        (state["hist"], "hist", i32, (b, S.HIST_LEN)),
        (state["bufs"], "bufs", f32, (n, b, ctx_len, d)),
    ]
    for name in ("top_p", "temperature", "recovery_top_p", "recovery_temp"):
        checks.append((settings[name], name, f32, (b,)))
    checks.append((settings["min_gen"], "min_gen", i32, (b,)))
    for t, name, dtype, shape in checks:
        _need(t, name, dtype, shape, dev)

    tokens = torch.empty((b, int(n_steps)), dtype=i32, device=dev)
    out = {name: torch.empty_like(state[name]) for name in STATE_KEYS}

    args = _Args()
    for name, val in (
        ("B", b), ("S", s_max), ("n_steps", int(n_steps)), ("L", l_txt), ("D", d),
        ("N", n), ("K", k), ("CTX", ctx_len), ("A", a_n), ("H", TEXT_HEADS),
        ("V", v), ("Vp", vp), ("freq", freq), ("anti_loop", int(bool(anti_loop))),
        ("eos", int(cfg.eos_id)), ("hist_len", S.HIST_LEN), ("top_k", TOP_K),
        ("loop_streak", LOOP_STREAK),
    ):
        setattr(args, name, val)
    for i, dil in enumerate(cfg.ar_dilations()):
        args.dils[i] = int(dil)
    args.rep_pen = REP_PENALTY
    bind = {
        "top_p": settings["top_p"], "temp": settings["temperature"],
        "rtp": settings["recovery_top_p"], "rtemp": settings["recovery_temp"],
        "min_gen": settings["min_gen"],
        "t_in": state["t"], "last_in": state["last"], "streak_in": state["streak"],
        "stopped_in": state["stopped"], "feos_in": state["first_eos"],
        "key_in": state["key"], "hist_in": state["hist"], "bufs_in": state["bufs"],
        "cond": cond, "emb": ctx.emb, "kv_k": kv_k, "kv_v": kv_v, "mask": mask,
        "tokens": tokens, "t_out": out["t"], "last_out": out["last"],
        "streak_out": out["streak"], "stopped_out": out["stopped"],
        "feos_out": out["first_eos"], "key_out": out["key"],
        "hist_out": out["hist"], "bufs_out": out["bufs"],
    }
    bind.update({name: w[name] for name in (
        "norm", "glu_w", "glu_b", "dw_w", "dw_b", "ff_norm", "ff1_w", "ff1_b",
        "ff2_w", "ff2_b", "x_nq", "x_q", "x_out", "x_gate", "out_norm",
        "head_w", "head_b",
    )})
    for name, t in bind.items():
        setattr(args, name, t.data_ptr())

    fn = kernels.lib("ar_loop").sopro_ar_loop
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cluster = ctypes.c_int(0)
    rc = fn(ctypes.byref(args), ctypes.byref(cluster), kernels.stream_ptr(dev))
    kernels.check(rc, "ar_loop")
    kernels.LAUNCHES["ar_loop"] += 1
    kernels.LAUNCH_INFO["ar_loop"] = {"cluster_blocks_per_row": cluster.value}
    return tokens, out
