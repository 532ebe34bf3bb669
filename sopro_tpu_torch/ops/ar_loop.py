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
    CUDA the kernel's packed weight stream per grid size. `kv_k` / `kv_v`
    [A, B, H, L, hd], when given, are the text KV already stacked as the
    kernel reads it (`kv` then holds views of them); else each launch
    stacks `kv`."""

    cfg: SoproTTSConfig
    p_ar: Dict
    stacked: Optional[Dict[str, torch.Tensor]]
    kv: List[Optional[Dict]]
    mask: torch.Tensor  # [B, L] bool
    emb: torch.Tensor  # [V+1, D]
    stream: Optional[Callable[[int], Dict]] = None  # grid blocks -> packed weights (CUDA)
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
CONSUMERS = 480  # kConsumers in csrc/ar_loop.cu (plus one producer warp)
RING, STAGE = 3, 8192  # kRing, kStage: the streamed ring's stages, floats per stage
MAX_GROUP = 32  # kMaxGroup: rows a step takes at once
MAX_OWN, OWN_INTS = 4, 80  # kMaxOwn, kOwnInts: sampler rows a block, ints each
RES_L = 2048  # kResL: the text length the resident prefix is sized at
SAMPLER_WARPS = 8  # kSampWarps: a row's sampler is two warpgroups
SMEM_PER_BLOCK = 232448  # 227 KB: the most shared memory a Hopper block can have
DEFAULT_BLOCKS = 132  # an H100 SXM's SMs: the grid the CPU mirrors assume
STREAM_DTYPES = (torch.float32, torch.bfloat16)


def _esize(dtype) -> int:
    """Bytes per element of the weight stream (4 or 2)."""
    if dtype not in STREAM_DTYPES:
        raise ValueError(f"the AR kernels take float32 or bfloat16 weights, not {dtype}")
    return torch.tensor([], dtype=dtype).element_size()


def _part(n: int, blocks: int, j: int) -> int:
    return n * j // blocks


def block_layout(cfg: SoproTTSConfig, blocks: int, j: int) -> Dict[str, int]:
    """csrc/ar_loop.cu `layout`: what block j of `blocks` owns, {c0, cw}
    of the D channels (GLU, conv, x_q / x_out columns, h), {f0, fw} of the
    4D hidden columns (ff1 columns, ff2 rows), {v0, vw} of the V logits."""
    d, v = int(cfg.d_model), int(cfg.ar_vocab)
    out = {}
    for key, n in (("c", d), ("f", 4 * d), ("v", v)):
        lo = _part(n, blocks, j)
        out[key + "0"], out[key + "w"] = lo, _part(n, blocks, j + 1) - lo
    return out


def stream_slices(cfg: SoproTTSConfig, blocks: int, j: int) -> List[Tuple[str, int, int]]:
    """(name, layer or attention index, rows) of the slices block j reads in
    one pass, in order (csrc/ar_loop.cu `stream_schedule`), each [rows][D]
    with D contiguous: per layer its GLU columns (a then b), ff1 columns and
    ff2 rows, after every freq-th layer its x_q and x_out columns; then its
    head columns."""
    n, freq = int(cfg.n_layers_ar), int(cfg.ar_text_attn_freq)
    ly = block_layout(cfg, blocks, j)
    out = []
    for li in range(n):
        out += [("glu_w", li, 2 * ly["cw"]), ("ff1_w", li, ly["fw"]), ("ff2_w", li, ly["fw"])]
        if (li + 1) % freq == 0:
            out += [("x_q", li // freq, ly["cw"]), ("x_out", li // freq, ly["cw"])]
    return out + [("head_w", 0, ly["vw"])]


def stream_schedule(
    cfg: SoproTTSConfig, blocks: int, j: int, dtype=torch.float32
) -> Tuple[List[Tuple[int, int]], int]:
    """([(offset, elements)] per chunk of block j's pass, elements): each
    slice in chunks of whole rows that fill at most one 32 KB stage
    (STAGE floats, twice as many bfloat16 elements)."""
    d = int(cfg.d_model)
    rpc = STAGE * 4 // _esize(dtype) // d
    chunks, off = [], 0
    for _, _, rows in stream_slices(cfg, blocks, j):
        for r0 in range(0, rows, rpc):
            chunks.append((off, min(rpc, rows - r0) * d))
            off += chunks[-1][1]
    return chunks, off


def _block_slice(w: Dict[str, torch.Tensor], name: str, i: int, ly: Dict[str, int], d: int):
    c0, c1 = ly["c0"], ly["c0"] + ly["cw"]
    if name == "glu_w":
        return torch.cat([w[name][i][:, c0:c1], w[name][i][:, d + c0:d + c1]], 1).t()
    if name == "ff1_w":
        return w[name][i][:, ly["f0"]:ly["f0"] + ly["fw"]].t()
    if name == "ff2_w":
        return w[name][i][ly["f0"]:ly["f0"] + ly["fw"]]
    if name in ("x_q", "x_out"):
        return w[name][i][:, c0:c1].t()
    return w["head_w"][:, ly["v0"]:ly["v0"] + ly["vw"]].t()


def pack_ar_stream(w: Dict[str, torch.Tensor], cfg: SoproTTSConfig, blocks: int) -> Dict:
    """The stacked weights (`ARGenerator.stacked()`) as K1/K5 read them over
    a grid of `blocks`: {"w": [blocks, len] in the weights' dtype, block j's
    slices back to back in `stream_slices` order (zero past its own length),
    "len": the longest block's elements, "grid": blocks}."""
    d = int(cfg.d_model)
    per = []
    for j in range(blocks):
        ly = block_layout(cfg, blocks, j)
        per.append(torch.cat([_block_slice(w, name, i, ly, d).reshape(-1)
                              for name, i, _ in stream_slices(cfg, blocks, j)]))
    length = max(int(p.numel()) for p in per)
    out = torch.zeros((blocks, length), dtype=w["head_w"].dtype, device=w["head_w"].device)
    for j, p in enumerate(per):
        out[j, :p.numel()] = p
    return {"w": out, "len": length, "grid": blocks}


def _r4(n: int) -> int:
    return (n + 3) // 4 * 4


def _ceil(n: int, d: int) -> int:
    return -(-n // d)


def _carve_words(cfg: SoproTTSConfig, blocks: int, rg: int, text_len: int, b: int,
                 res_words: int, streamed: bool, nchunk_max: int) -> int:
    """csrc/ar_loop.cu `carve(...).total`: shared-memory words of a block."""
    d, n, k, v = int(cfg.d_model), int(cfg.n_layers_ar), int(cfg.ar_kernel), int(cfg.ar_vocab)
    a_n = n // int(cfg.ar_text_attn_freq)
    cwm, fwm, vwm = _ceil(d, blocks), _ceil(4 * d, blocks), _ceil(v, blocks)
    ym = max(2 * cwm, fwm, vwm)
    return (16 + res_words + (RING * STAGE if streamed else 0) + _r4(rg * d) + _r4(rg * cwm)
            + _r4(rg * ym) + _r4(n * (k - 1) * rg * cwm) + CONSUMERS + _r4(text_len) + 2 * _r4(d)
            + _r4(n * (cwm * (k + 4) + fwm) + vwm + a_n) + 2 * CONSUMERS // 32
            + 2 * 8 * SAMPLER_WARPS + _r4(v) + _r4(_ceil(v, 32)) + MAX_OWN * OWN_INTS + _r4(5 * b) + _r4(2 * nchunk_max) + 16)


def key_chunks(blocks: int, rows: int, heads: int, length: int) -> int:
    """csrc/ar_loop.cu `key_chunks`: the text attention's key chunks per
    (row, head), as many as spread the units over the blocks, of at least 32
    keys."""
    return max(1, min(blocks // (rows * heads), -(-length // 32)))


_PLANS: Dict[tuple, Optional[Dict[str, int]]] = {}


def launch_plan(cfg: SoproTTSConfig, text_len: int, dtype=torch.float32, b: int = 1,
                blocks: int = DEFAULT_BLOCKS) -> Optional[Dict[str, int]]:
    """csrc/ar_loop.cu `plan` and `configure` on the host: {rg (rows a step
    takes at once), groups, streamed (the ring runs), res_elems (the
    resident prefix), nchunk_max, len_max, smem (bytes a block)} of K1 / K5
    over `blocks` blocks for B = b rows at text length `text_len`, or None
    where no group size fits 227 KB. Kept per shape (the engine asks it on
    every route)."""
    key = (int(cfg.d_model), int(cfg.n_layers_ar), int(cfg.ar_kernel), int(cfg.ar_vocab),
           int(cfg.ar_text_attn_freq), tuple(cfg.ar_dilations()), int(text_len), str(dtype),
           int(b), int(blocks))
    if key not in _PLANS:
        _PLANS[key] = _launch_plan(cfg, int(text_len), dtype, int(b), int(blocks))
    return _PLANS[key]


def _launch_plan(cfg, text_len, dtype, b, blocks):
    d, ctx = int(cfg.d_model), conv_ctx(cfg)
    es = _esize(dtype)
    scheds = [stream_schedule(cfg, blocks, j, dtype) for j in range(blocks)]
    len_max = max(s[1] for s in scheds)
    nchunk_max = max(len(s[0]) for s in scheds)
    lres = max(int(text_len), RES_L)
    first = min(int(b), MAX_GROUP)
    rg = first
    while rg >= 1:
        fixed = _carve_words(cfg, blocks, rg, lres, b, 0, False, nchunk_max)
        avail = SMEM_PER_BLOCK - 4 * fixed
        whole = _r4(_ceil(len_max * es, 4)) * 4
        ring = RING * STAGE * 4
        if fixed * 4 <= SMEM_PER_BLOCK and (whole <= avail or avail >= ring):
            streamed = whole > avail
            res_elems = (avail - ring) // 16 * 16 // es if streamed else len_max
            res_words = _r4(_ceil(res_elems * es, 4))
            smem = 4 * _carve_words(cfg, blocks, rg, int(text_len), b, res_words, streamed,
                                    nchunk_max)
            nc = key_chunks(blocks, rg, TEXT_HEADS, text_len)
            if (ctx * _ceil(d, blocks) > rg * d or smem > SMEM_PER_BLOCK or b > MAX_OWN * blocks
                    or rg * TEXT_HEADS * (nc + 1) > CONSUMERS):
                return None
            return {"rg": rg, "groups": _ceil(int(b), rg), "streamed": int(streamed),
                    "res_elems": res_elems, "nchunk_max": nchunk_max, "len_max": len_max,
                    "smem": smem}
        rg = 16 if rg == first and rg > 16 else rg // 2
    return None


def smem_bytes(cfg: SoproTTSConfig, text_len: int, dtype=torch.float32, b: int = 1,
               blocks: int = DEFAULT_BLOCKS) -> Optional[int]:
    """Shared memory per block that csrc/ar_loop.cu asks for at text length
    `text_len`, weights of `dtype`, B = b rows, over a grid of `blocks`: a
    host mirror of its `plan` and `carve`; where no layout fits 227 KB, what
    its smallest layout (one row a step, nothing resident) would ask for.
    None for a batch the kernel never takes (more than MAX_OWN rows a
    block). K1 and K5 take the same amount; the step count does not enter
    (the steps loop inside), B only through the rows a step takes at once
    (at most 32: more rows go through each step in groups)."""
    plan = launch_plan(cfg, text_len, dtype, b, blocks)
    if plan is not None:
        return plan["smem"]
    if b > MAX_OWN * blocks:
        return None
    nchunk_max = max(len(stream_schedule(cfg, blocks, j, dtype)[0]) for j in range(blocks))
    return max(SMEM_PER_BLOCK + 1,
               4 * _carve_words(cfg, blocks, 1, int(text_len), b, 0, True, nchunk_max))


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
        + [("stream_len", ctypes.c_int), ("grid", ctypes.c_int), ("xch", ctypes.c_void_p),
           ("sync", ctypes.c_void_p)]
        + [(n, ctypes.c_int) for n in ("rg", "nc", "res_elems", "streamed", "nchunk_max")]
        + [("xch_half", ctypes.c_longlong)]
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
    "sopro_ar_launch_info": [ctypes.POINTER(_Args), ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
    "sopro_ar_loop": [ctypes.POINTER(_Args), ctypes.c_void_p],
    "sopro_ar_step": [ctypes.POINTER(_Args), ctypes.c_void_p],
}
_ARGTYPES.update({
    "sopro_ar_loop_bf16": _ARGTYPES["sopro_ar_loop"], "sopro_ar_step_bf16": _ARGTYPES["sopro_ar_step"],
})
INFO_KEYS = ("blocks", "rows_per_group", "row_groups", "waves", "smem_bytes", "resident_chunks",
             "chunks", "xch_half", "streamed", "key_chunks")
_FACTS: Dict[tuple, Dict[str, int]] = {}
_WORKSPACE: Dict[torch.device, Dict[str, torch.Tensor]] = {}


def _mode(logits_only: bool, dtype) -> int:
    """csrc/ar_loop.cu's `mode`: bit 0 K5, bit 1 the bfloat16 instantiation."""
    return int(logits_only) | (2 if dtype == torch.bfloat16 else 0)


def launch_facts(args: _Args, logits_only: bool, dtype, device) -> Dict[str, int]:
    """What csrc/ar_loop.cu's launch takes for these shapes and weight dtype
    on CUDA `device` (the current device: call inside `kernels.on_device`),
    asked once per library, card model and shape (`sopro_ar_launch_info`):
    the grid's blocks (one per SM; the weight stream is packed for it), the
    rows a step takes at once and the row groups, waves (1: every block is
    resident), shared memory a block, block 0's resident and total chunks,
    the exchange buffer's half (floats), whether the ring streams, the
    attention's key chunks."""
    lib = kernels.lib("ar_loop")
    mode = _mode(logits_only, dtype)
    key = (id(lib), torch.cuda.get_device_name(device), mode) + tuple(
        getattr(args, f) for f in ("B", "L", "D", "N", "K", "CTX", "H", "V", "freq", "hist_len"))
    if key not in _FACTS:
        out = (ctypes.c_int * len(INFO_KEYS))()
        fn = kernels.entry("ar_loop", "sopro_ar_launch_info", _ARGTYPES["sopro_ar_launch_info"])
        kernels.check(fn(ctypes.byref(args), mode, out), "ar_loop launch info")
        _FACTS[key] = dict(zip(INFO_KEYS, out))
    return _FACTS[key]


def _workspace(device, half: int) -> Dict[str, torch.Tensor]:
    """The exchange buffer (two halves of at least `half` floats) and the
    arrival counter of `device`, kept and grown per device. Launches on one
    device run in stream order, so one workspace serves them all."""
    ws = _WORKSPACE.get(device)
    if ws is None or ws["xch"].numel() < 2 * half:
        ws = {"xch": torch.empty(2 * half, dtype=torch.float32, device=device),
              "sync": torch.zeros(1, dtype=torch.int64, device=device)}
        _WORKSPACE[device] = ws
    return ws


def launch(kernel: str, entry: str, args: _Args, device, stream, dtype=torch.float32) -> None:
    """Call C entry point `entry` of csrc/ar_loop.cu (its `_bf16`
    instantiation for bfloat16 weights) on `device` and its current stream
    with the weight stream packed for its grid (`stream(blocks)`,
    `ARGenerator.stream`) and the device's workspace, raise on a refused
    launch, count it under `kernel` and `dtype`."""
    if stream is None:
        raise ValueError(f"{kernel}: the context carries no weight stream (built on the CPU?)")
    with kernels.on_device(device) as cuda_stream:
        facts = launch_facts(args, entry == "sopro_ar_step", dtype, device)
        pack = stream(facts["blocks"])
        if pack["w"].dtype != dtype:
            raise ValueError(f"{kernel}: the weight stream is {pack['w'].dtype}, the weights {dtype}")
        ws = _workspace(device, facts["xch_half"])
        args.wstream, args.stream_len, args.grid = pack["w"].data_ptr(), pack["len"], pack["grid"]
        args.xch, args.sync, args.xch_half = ws["xch"].data_ptr(), ws["sync"].data_ptr(), ws["xch"].numel() // 2
        name = entry + ("_bf16" if dtype == torch.bfloat16 else "")
        fn = kernels.entry("ar_loop", name, _ARGTYPES[name])
        kernels.check(fn(ctypes.byref(args), cuda_stream), kernel)
    kernels.count(kernel, dtype)
    kernels.LAUNCH_INFO[kernel] = dict(facts, sms=torch.cuda.get_device_properties(device).multi_processor_count)


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


def launch_info(ctx: ARLoopContext, cond, state, settings) -> Dict[str, int]:
    """K1's launch facts for these shapes (`launch_facts`, plus the card's
    SM count): one launch of one block per SM decodes every row, in
    `row_groups` groups of `rows_per_group`, in one wave. Launches nothing."""
    args, _, _, _keep = _loop_args(ctx, cond, state, settings, 1, True)
    with kernels.on_device(cond.device):
        facts = launch_facts(args, False, cond.dtype, cond.device)
    return dict(facts, sms=torch.cuda.get_device_properties(cond.device).multi_processor_count)
