"""Kernel K1's weight stream and shared-memory budget on the CPU (no kernel
runs here).

K1 and K5 read each rank's weight slices from one contiguous stream per
rank, packed once per device in the order the kernel reads them
(`ops/ar_loop.py::pack_ar_stream`, mirroring `stream_schedule` of
csrc/ar_loop.cu), through a ring of whole-row chunks. Held here: the
packing gives back the stacked weights bit for bit at cluster sizes 16, 8
and 4 (full Sopro v1.5 shapes); every text bucket up to 2,048 fits the 227
KB a Hopper block may have, so the engine keeps routing to K1; and the
plain step fed only from the packed stream, chunk by chunk as the ring
hands it out and across steps, decodes token for token as `ar_loop_plain`
at near-greedy settings (its logits bit-equal: the same weights reach the
same plain ops).
"""

import copy

import numpy as np
import pytest
import torch

from sopro_tpu_torch import weights as W
from sopro_tpu_torch.config import RuntimeConfig, SoproTTSConfig
from sopro_tpu_torch.engine import ar_route
from sopro_tpu_torch.models import sopro as M
from sopro_tpu_torch.models.generator import ar_step as generator_step
from sopro_tpu_torch.ops.ar_loop import (
    SMEM_PER_BLOCK, STAGE, _layout, ar_loop_plain, pack_ar_stream, smem_bytes, stream_schedule,
    stream_slices,
)

from tests.test_torch_cuda import CFG, TEXT_VOCAB

torch.set_num_threads(1)

STREAMED = ("glu_w", "ff1_w", "ff2_w", "x_q", "x_out", "head_w")


def _full_width_stacked(cfg):
    """Random tensors of the stacked view's streamed shapes at `cfg`."""
    d, n, v = cfg.d_model, cfg.n_layers_ar, cfg.ar_vocab
    a_n = n // cfg.ar_text_attn_freq
    g = torch.Generator().manual_seed(0)
    shapes = {"glu_w": (n, d, 2 * d), "ff1_w": (n, d, 4 * d), "ff2_w": (n, 4 * d, d),
              "x_q": (a_n, d, d), "x_out": (a_n, d, d), "head_w": (d, v + (-v) % 4)}
    return {k: torch.randn(*s, generator=g) for k, s in shapes.items()}


def _unpack(pack, cfg):
    """The stacked weights a stream holds, reassembled rank by rank in
    `stream_slices` order (head_w [D, Vp])."""
    cs, d, n = pack["cs"], cfg.d_model, cfg.n_layers_ar
    v = cfg.ar_vocab
    cw, fw, vw = _layout(cfg, cs)
    a_n = n // cfg.ar_text_attn_freq
    out = {"glu_w": torch.zeros(n, d, 2 * d), "ff1_w": torch.zeros(n, d, 4 * d),
           "ff2_w": torch.zeros(n, 4 * d, d), "x_q": torch.zeros(a_n, d, d),
           "x_out": torch.zeros(a_n, d, d), "head_w": torch.zeros(d, cs * vw)}
    for r in range(cs):
        off, c0, f0 = 0, r * cw, r * fw
        for name, i, rows, width in stream_slices(cfg, cs):
            blk = pack["w"][r, off:off + rows * width].reshape(rows, width)
            off += rows * width
            if name == "glu_w":
                out[name][i][:, c0:c0 + cw], out[name][i][:, d + c0:d + c0 + cw] = blk[:, :cw], blk[:, cw:]
            elif name in ("ff1_w", "x_q"):
                width_r = fw if name == "ff1_w" else cw
                out[name][i][:, r * width_r:(r + 1) * width_r] = blk
            elif name in ("ff2_w", "x_out"):
                out[name][i][r * rows:(r + 1) * rows] = blk
            else:
                out[name][:, r * vw:(r + 1) * vw] = blk
    out["head_w"] = out["head_w"][:, :v + (-v) % 4]
    return out


@pytest.mark.parametrize("cs", [16, 8, 4])
def test_stream_packing_reassembles_the_stacked_weights(cs):
    """Full width: D 384, six layers, three text attentions, V 2,049 (Vp
    2,052): unpacking the stream gives every streamed weight back exactly;
    each rank's stream is as long as its schedule, every chunk whole rows of
    one slice within one ring stage."""
    cfg = SoproTTSConfig()
    w = _full_width_stacked(cfg)
    pack = pack_ar_stream(w, cfg, cs)
    chunks, length = stream_schedule(cfg, cs)
    assert pack["w"].shape == (cs, length) and pack["len"] == length
    back = _unpack(pack, cfg)
    for k in STREAMED:
        assert torch.equal(back[k], w[k]), k
    assert all(0 < n <= STAGE for _, n in chunks)
    assert sum(n for _, n in chunks) == length
    widths = {width for _, _, _, width in stream_slices(cfg, cs)}
    assert all(width % 4 == 0 for width in widths)


def test_every_text_bucket_fits_and_routes_to_k1():
    """At full width K1's shared memory (the host mirror of the launch) fits
    227 KB at every text bucket up to 2,048, so the rule keeps K1."""
    cfg = SoproTTSConfig()
    buckets = RuntimeConfig().text_buckets
    assert max(buckets) == 2048
    for l_txt in buckets:
        smem = smem_bytes(cfg, l_txt)
        assert smem is not None and smem <= SMEM_PER_BLOCK, l_txt
        assert ar_route("cuda", b=1, resident=True, eligible=smem <= SMEM_PER_BLOCK,
                        use_step=True) == "ar_loop"
    assert smem_bytes(cfg, 2048) - smem_bytes(cfg, 64) == 4 * (2048 - 64)


class _Reader:
    """One rank's stream taken chunk by chunk in schedule order, as the
    kernel's ring hands it out (the count runs on across steps)."""

    def __init__(self, pack, cfg):
        self.pack, self.chunks = pack, stream_schedule(cfg, pack["cs"])[0]
        self.k = 0

    def slice(self, r, rows, width):
        rpc, parts = STAGE // width, []
        for r0 in range(0, rows, rpc):
            off, n = self.chunks[self.k % len(self.chunks)]
            self.k += 1
            assert n == min(rpc, rows - r0) * width
            parts.append(self.pack["w"][r, off:off + n].reshape(-1, width))
        return torch.cat(parts)


class _StreamedStep:
    """The plain step whose streamed weights come, every step, from the
    packed stream of all cs ranks read in the kernel's order."""

    def __init__(self, ctx, pack, cfg):
        self.ctx, self.cfg, self.pack = ctx, cfg, pack
        self.readers = [_Reader(pack, cfg) for _ in range(pack["cs"])]
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self.ctx, name)

    def step(self, x, bufs):
        cfg, cs, d = self.cfg, self.pack["cs"], self.cfg.d_model
        per_rank = [{} for _ in range(cs)]
        for r, reader in enumerate(self.readers):
            for name, i, rows, width in stream_slices(cfg, cs):
                per_rank[r][(name, i)] = reader.slice(r, rows, width)
        p = copy.copy(self.ctx.p_ar)
        p["blocks"] = [copy.deepcopy(b) for b in p["blocks"]]
        p["xattn"] = [None if x_ is None else copy.deepcopy(x_) for x_ in p["xattn"]]
        p["head"] = dict(p["head"])
        cw = d // cs
        for li, blk in enumerate(p["blocks"]):
            glu = [per_rank[r][("glu_w", li)] for r in range(cs)]
            blk["glu"]["pro"]["w"] = torch.cat([g[:, :cw] for g in glu] + [g[:, cw:] for g in glu], 1)
            blk["ff1"]["w"] = torch.cat([per_rank[r][("ff1_w", li)] for r in range(cs)], 1)
            blk["ff2"]["w"] = torch.cat([per_rank[r][("ff2_w", li)] for r in range(cs)], 0)
        attn = [x_ for x_ in p["xattn"] if x_ is not None]
        for ai, xp in enumerate(attn):
            xp["q"]["w"] = torch.cat([per_rank[r][("x_q", ai)] for r in range(cs)], 1)
            xp["out"]["w"] = torch.cat([per_rank[r][("x_out", ai)] for r in range(cs)], 0)
        p["head"]["w"] = torch.cat([per_rank[r][("head_w", 0)] for r in range(cs)],
                                   1)[:, :cfg.ar_vocab]
        self.calls += 1
        return generator_step(p, cfg, x, bufs, self.ctx.kv)


@pytest.mark.parametrize("cs", [16, 4])
def test_plain_step_over_the_stream_decodes_as_ar_loop_plain(cs):
    """Small config (D 64, two layers, one text attention): up to 20
    near-greedy steps (the row stops at its EOS) of the loop whose step reads
    its weights only through the stream give ar_loop_plain's tokens and
    state, and the same logits bit for bit."""
    cfg = SoproTTSConfig(**CFG)
    tree = W.init_sopro_params(5, cfg, TEXT_VOCAB)
    W.fill_zero_inits(tree, None, 6)
    model = W.sopro_params_from_jax(tree, cfg, "cpu")
    g = torch.Generator().manual_seed(2)
    txt = torch.randn(1, 12, cfg.d_model, generator=g)
    mask = (torch.arange(12) < 9)[None]
    cond = torch.randn(1, 21, cfg.d_model, generator=g) * 0.1
    ctx = M.ar_context(model, txt, mask)
    pack = pack_ar_stream(model.ar.stacked(), cfg, cs)
    streamed = _StreamedStep(ctx, pack, cfg)

    def fresh():
        c = M.init_ar_carry(cfg, 1, 21, 7, "cpu")
        return {k: getattr(c, k) for k in ("t", "last", "streak", "stopped", "first_eos", "key",
                                           "hist", "bufs")}

    sett = M.ARSettings(temperature=1e-4, anti_loop=False).per_row(1, "cpu")
    want, ws = ar_loop_plain(ctx, cond, fresh(), sett, 20, False)
    got, gs = ar_loop_plain(streamed, cond, fresh(), sett, 20, False)
    assert torch.equal(got, want)
    for k in ("t", "last", "streak", "stopped", "first_eos", "key", "hist", "bufs"):
        assert torch.equal(gs[k], ws[k]), k
    nchunk = len(stream_schedule(cfg, cs)[0])
    assert streamed.calls > 2 and all(rd.k == streamed.calls * nchunk for rd in streamed.readers)
    x = torch.randn(1, cfg.d_model, generator=torch.Generator().manual_seed(2))
    assert torch.equal(streamed.step(x, ws["bufs"])[0], ctx.step(x, ws["bufs"])[0])
