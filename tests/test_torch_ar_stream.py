"""Kernel K1's layout over the card on the CPU (no kernel runs here).

K1 and K5 run one persistent launch of one block per SM. Block j owns a
fixed slice of every product (channels of D for the GLU, the conv, x_q,
x_out and the residual; hidden columns of 4D for ff1 and rows of ff2;
logits of V for the head) and reads its slices from one contiguous stream,
packed once per device in the order the kernel reads them
(`ops/ar_loop.py::pack_ar_stream`, mirroring `stream_schedule` of
csrc/ar_loop.cu); a prefix stays resident in shared memory, the rest
streams through a ring. Held here: the packing gives back the stacked
weights bit for bit at grids of 132, 64 and 16 blocks (full Sopro v1.5
shapes), its resident prefix and streamed chunks included; the launch plan
(the host mirror of `plan` / `carve`) fits every text bucket up to 2,048 and
every B up to 128 in one wave; and a plain emulation of the partitioned,
row-batched step (weights only from the packed stream, ff2's partial sums
added per channel in the kernel's block order, the attention split in key
chunks and combined as the kernel combines them) decodes token for token
as `ar_loop_plain` at B = 1, 3 and 8, rows at different ages and one
stopped.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sopro_tpu_torch import weights as W
from sopro_tpu_torch.config import RuntimeConfig, SoproTTSConfig
from sopro_tpu_torch.engine import ar_route
from sopro_tpu_torch.models import sopro as M
from sopro_tpu_torch.models.generator import TEXT_HEADS
from sopro_tpu_torch.ops.ar_loop import (
    CONSUMERS, SMEM_PER_BLOCK, STAGE, ar_loop_plain, key_chunks, block_layout, launch_plan, pack_ar_stream,
    smem_bytes, stream_schedule, stream_slices,
)

from tests.test_torch_cuda import CFG, TEXT_VOCAB

torch.set_num_threads(1)

STREAMED = ("glu_w", "ff1_w", "ff2_w", "x_q", "x_out", "head_w")


def _full_width_stacked(cfg, dtype=torch.float32):
    """Random tensors of the stacked view's streamed shapes at `cfg`."""
    d, n, v = cfg.d_model, cfg.n_layers_ar, cfg.ar_vocab
    a_n = n // cfg.ar_text_attn_freq
    g = torch.Generator().manual_seed(0)
    shapes = {"glu_w": (n, d, 2 * d), "ff1_w": (n, d, 4 * d), "ff2_w": (n, 4 * d, d),
              "x_q": (a_n, d, d), "x_out": (a_n, d, d), "head_w": (d, v + (-v) % 4)}
    return {k: torch.randn(*s, generator=g).to(dtype) for k, s in shapes.items()}


def _block_slices(pack, cfg, j, elems=None):
    """Block j's slices {(name, index): [rows, D]} read from its stream, or
    from `elems` (its stream as the kernel sees it) when given."""
    d, off, out = cfg.d_model, 0, {}
    row = pack["w"][j] if elems is None else elems
    for name, i, rows in stream_slices(cfg, pack["grid"], j):
        out[(name, i)] = row[off:off + rows * d].reshape(rows, d)
        off += rows * d
    return out


def _unpack(pack, cfg, dtype, kernel_view=None):
    """The stacked weights a stream holds, reassembled block by block
    (head_w [D, Vp] with zero padding columns); `kernel_view(j)` gives block
    j's stream as the kernel reads it."""
    d, n, v = cfg.d_model, cfg.n_layers_ar, cfg.ar_vocab
    a_n = n // cfg.ar_text_attn_freq
    out = {"glu_w": torch.zeros(n, d, 2 * d, dtype=dtype), "ff1_w": torch.zeros(n, d, 4 * d, dtype=dtype),
           "ff2_w": torch.zeros(n, 4 * d, d, dtype=dtype), "x_q": torch.zeros(a_n, d, d, dtype=dtype),
           "x_out": torch.zeros(a_n, d, d, dtype=dtype), "head_w": torch.zeros(d, v + (-v) % 4, dtype=dtype)}
    for j in range(pack["grid"]):
        ly = block_layout(cfg, pack["grid"], j)
        c0, c1, f0, f1 = ly["c0"], ly["c0"] + ly["cw"], ly["f0"], ly["f0"] + ly["fw"]
        sl = _block_slices(pack, cfg, j, None if kernel_view is None else kernel_view(j))
        for (name, i), blk in sl.items():
            if name == "glu_w":
                out[name][i][:, c0:c1], out[name][i][:, d + c0:d + c1] = blk[:ly["cw"]].t(), blk[ly["cw"]:].t()
            elif name == "ff1_w":
                out[name][i][:, f0:f1] = blk.t()
            elif name == "ff2_w":
                out[name][i][f0:f1] = blk
            elif name in ("x_q", "x_out"):
                out[name][i][:, c0:c1] = blk.t()
            else:
                out[name][:, ly["v0"]:ly["v0"] + ly["vw"]] = blk.t()
    return out


@pytest.mark.parametrize("blocks", [132, 64, 16])
def test_stream_packing_reassembles_the_stacked_weights(blocks):
    """Full width: D 384, six layers, three text attentions, V 2,049 (Vp
    2,052): unpacking the stream gives every streamed weight back exactly,
    also when read as the kernel reads it (the resident prefix of the fp32
    plan at B = 8 from its place, every other chunk from the stream), and
    the bfloat16 stream too; each block's stream is as long as its
    schedule, every chunk whole rows of one slice within one ring stage."""
    cfg = SoproTTSConfig()
    for dtype in (torch.float32, torch.bfloat16):
        w = _full_width_stacked(cfg, dtype)
        pack = pack_ar_stream(w, cfg, blocks)
        scheds = [stream_schedule(cfg, blocks, j, dtype) for j in range(blocks)]
        assert pack["w"].shape == (blocks, pack["len"]) and pack["w"].dtype == dtype
        assert pack["len"] == max(length for _, length in scheds)
        back = _unpack(pack, cfg, dtype)
        for k in STREAMED:
            want = w[k] if k != "head_w" else F.pad(w[k][:, :cfg.ar_vocab], (0, w[k].shape[1] - cfg.ar_vocab))
            assert torch.equal(back[k], want), (k, dtype)
        stage = STAGE * 4 // torch.tensor([], dtype=dtype).element_size()
        for chunks, length in scheds:
            assert all(0 < n <= stage and n % cfg.d_model == 0 for _, n in chunks)
            assert [o for o, _ in chunks] == [sum(n for _, n in chunks[:i]) for i in range(len(chunks))]
            assert sum(n for _, n in chunks) == length
        plan = launch_plan(cfg, 256, dtype, 8, blocks)
        if plan is None:
            continue
        split = []

        def kernel_view(j, plan=plan, scheds=scheds, pack=pack):
            """Block j's stream chunk by chunk as the kernel takes it: the
            longest prefix within res_elems from its resident copy (loaded
            once), every later chunk from the stream the ring reads."""
            chunks, length = scheds[j]
            nres, tot = 0, 0
            while nres < len(chunks) and tot + chunks[nres][1] <= plan["res_elems"]:
                tot, nres = tot + chunks[nres][1], nres + 1
            split.append((nres, len(chunks)))
            resident = pack["w"][j, :tot].clone()
            parts = [resident[off:off + n] if c < nres else pack["w"][j, off:off + n]
                     for c, (off, n) in enumerate(chunks)]
            assert sum(p.numel() for p in parts) == length
            return torch.cat(parts)

        back = _unpack(pack, cfg, dtype, kernel_view)
        if plan["streamed"]:
            assert all(nres < n for nres, n in split), split
            assert blocks != 132 or all(nres > 0 for nres, _ in split), split  # the card's grid
        for k in STREAMED[:-1]:
            assert torch.equal(back[k], w[k]), (k, dtype, "kernel view")


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_plan_takes_every_batch_in_one_wave(dtype):
    """Full width over 132 blocks at text bucket 2,048: every B JAX's K1
    takes (up to 128) fits one launch: up to 32 rows go through a step
    together, more in groups of 32; the bfloat16 stream stays resident
    whole up to 16 rows, float32 keeps a prefix and streams the rest."""
    cfg = SoproTTSConfig()
    for b in (1, 4, 7, 8, 16, 32, 33, 128):
        plan = launch_plan(cfg, 2048, dtype, b)
        assert plan is not None and plan["smem"] <= SMEM_PER_BLOCK, b
        assert plan["rg"] == min(b, 32) and plan["groups"] == math.ceil(b / 32), (b, plan)
        whole = dtype == torch.bfloat16 and b <= 16
        assert plan["streamed"] == (not whole), (b, plan)
        assert 0 < plan["res_elems"] <= plan["len_max"]
        assert smem_bytes(cfg, 2048, dtype, b) == plan["smem"]


def _rms(h, scale):
    return h * torch.rsqrt(torch.mean(h * h, -1, keepdim=True) + 1e-6) * scale


class _PartitionedStep:
    """The block stack of one step as csrc/ar_loop.cu partitions it over
    `blocks` blocks for all B rows at once, in plain float32 torch: each
    product from block j's slices of the packed stream only, ff2's partial
    sums added per channel in the kernel's order (an output's lpo lanes:
    lane l adds the partials of blocks l, l + lpo, ... in turn, then the
    lanes' butterfly),
    the text attention per key chunk (max, sum, unnormalised output)
    combined as the kernel combines them."""

    def __init__(self, ctx, stacked, cfg, blocks):
        self.ctx, self.w, self.cfg, self.blocks = ctx, stacked, cfg, blocks
        pack = pack_ar_stream(stacked, cfg, blocks)
        self.sl = [_block_slices(pack, cfg, j) for j in range(blocks)]
        self.ly = [block_layout(cfg, blocks, j) for j in range(blocks)]
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self.ctx, name)

    def _cols(self, x, name, i, key):
        """[B, n] of a column-split product: every block's columns in place."""
        parts = [x @ self.sl[j][(name, i)].t() for j in range(self.blocks)]
        return torch.cat(parts, 1)

    def _ff2_sum(self, hid_of, li, b):
        d, g = self.cfg.d_model, self.blocks
        partial = torch.stack([hid_of(j) @ self.sl[j][("ff2_w", li)] for j in range(g)])  # [G, B, D]
        out = torch.zeros(b, d)
        for j in range(g):
            c0, cw = self.ly[j]["c0"], self.ly[j]["cw"]
            opw = 1
            while opw < 32 and opw * (CONSUMERS // 32) < b * cw:
                opw *= 2
            lpo = 32 // opw
            lanes = torch.zeros(lpo, b, cw)
            for lane in range(lpo):
                for gg in range(lane, g, lpo):
                    lanes[lane] = lanes[lane] + partial[gg][:, c0:c0 + cw]
            o = lpo // 2
            while o > 0:  # the butterfly: lane l adds lane l ^ o
                lanes = lanes + lanes[torch.arange(lpo) ^ o]
                o //= 2
            out[:, c0:c0 + cw] = lanes[0]
        return out

    def _attend(self, q, kv, b):
        hd = self.cfg.d_model // TEXT_HEADS
        k, v, mask = kv["k"].float(), kv["v"].float(), kv["mask"].bool()
        length = k.shape[2]
        nc = key_chunks(self.blocks, b, TEXT_HEADS, length)
        lc = -(-length // nc)
        keep = mask.clone()
        keep[:, 0] |= ~torch.any(keep, -1)
        out = torch.zeros(b, self.cfg.d_model)
        for h in range(TEXT_HEADS):
            qh = q[:, h * hd:(h + 1) * hd]
            ms, ss, os_ = [], [], []
            for ci in range(nc):
                l0, l1 = ci * lc, min(length, (ci + 1) * lc)
                s = torch.einsum("bd,bld->bl", qh, k[:, h, l0:l1]) / math.sqrt(hd)
                s = torch.where(keep[:, l0:l1], s, torch.full_like(s, -math.inf))
                m = s.max(-1).values if l1 > l0 else torch.full((b,), -math.inf)
                e = torch.where(torch.isinf(m)[:, None], torch.zeros_like(s), torch.exp(s - m[:, None]))
                ms.append(m)
                ss.append(e.sum(-1))
                os_.append(torch.einsum("bl,bld->bd", e, v[:, h, l0:l1]))
            mx = torch.stack(ms).max(0).values
            ssum, o = torch.zeros(b), torch.zeros(b, hd)
            for m, s, oc in zip(ms, ss, os_):
                wgt = torch.where(torch.isinf(m), torch.zeros_like(m), torch.exp(m - mx))
                ssum = ssum + s * wgt
                o = o + oc * wgt[:, None]
            out[:, h * hd:(h + 1) * hd] = torch.nan_to_num(o / ssum[:, None], nan=0.0, posinf=0.0,
                                                           neginf=0.0)
        return out

    def step(self, x, bufs):
        cfg, w = self.cfg, self.w
        n, k, d, freq = cfg.n_layers_ar, cfg.ar_kernel, cfg.d_model, cfg.ar_text_attn_freq
        b, ctx_len = x.shape[0], bufs.shape[2]
        h, new_bufs = x.float(), []
        xs = _rms(h, w["norm"][0])
        for li, dil in enumerate(cfg.ar_dilations()):
            y = torch.cat([torch.cat([xs @ self.sl[j][("glu_w", li)][:self.ly[j]["cw"]].t()
                                      for j in range(self.blocks)], 1),
                           torch.cat([xs @ self.sl[j][("glu_w", li)][self.ly[j]["cw"]:].t()
                                      for j in range(self.blocks)], 1)], 1) + w["glu_b"][li]
            gl = y[:, :d] * torch.sigmoid(y[:, d:])
            buf = torch.cat([bufs[li][:, 1:], gl[:, None]], 1)
            span = (k - 1) * dil + 1
            conv = (buf[:, ctx_len - span::dil] * w["dw_w"][li][None]).sum(1) + w["dw_b"][li]
            h = h + conv
            new_bufs.append(buf)
            xs = _rms(h, w["ff_norm"][li])
            hid = [F.gelu(xs @ self.sl[j][("ff1_w", li)].t()
                          + w["ff1_b"][li][self.ly[j]["f0"]:self.ly[j]["f0"] + self.ly[j]["fw"]])
                   for j in range(self.blocks)]
            h = h + (self._ff2_sum(lambda j: hid[j], li, b) + w["ff2_b"][li])
            last = li + 1 == n
            if (li + 1) % freq == 0:
                ai = li // freq
                xs = _rms(h, w["x_nq"][ai])
                q = self._cols(xs, "x_q", ai, None)
                att = self._attend(q, self.ctx.kv[li], b)
                h = h + torch.tanh(w["x_gate"][ai]) * self._cols(att, "x_out", ai, None)
            xs = _rms(h, w["out_norm"] if last else w["norm"][li + 1])
        self.calls += 1
        logits = self._cols(xs, "head_w", 0, None) + w["head_b"][:cfg.ar_vocab]
        return logits, torch.stack(new_bufs)


AGES = (0, 3, 9, 1, 14, 6, 0, 11)


def _rows_state(cfg, b, s, rng):
    """b rows at AGES: the last token and a history of earlier tokens where
    t > 0, a random conv state, row 1 stopped when b > 1."""
    st = {k: getattr(M.init_ar_carry(cfg, b, s, 7, "cpu"), k)
          for k in ("t", "last", "streak", "stopped", "first_eos", "key", "hist", "bufs")}
    ages = np.asarray(AGES[:b], np.int32)
    hl = st["hist"].shape[1]
    toks = rng.integers(0, cfg.codebook_size, (b, hl + 1)).astype(np.int32)
    st["t"] = torch.from_numpy(ages)
    st["last"] = torch.from_numpy(np.where(ages > 0, toks[:, -1], 0).astype(np.int32))
    st["hist"] = torch.from_numpy(np.where(np.arange(hl)[None] >= hl - ages[:, None],
                                           toks[:, :-1], -1).astype(np.int32))
    st["bufs"] = torch.from_numpy(rng.standard_normal(tuple(st["bufs"].shape)).astype(np.float32) * 0.3)
    if b > 1:
        st["stopped"][1] = 1
    return st


@pytest.mark.parametrize("b,blocks", [(1, 16), (3, 64), (8, 5)])
def test_partitioned_step_decodes_as_ar_loop_plain(b, blocks):
    """Small config (D 64, two layers, one text attention, V 33): the loop
    whose step is the partitioned, row-batched emulation (uneven channel
    splits over `blocks` blocks, the attention in key chunks) gives
    ar_loop_plain's tokens and state over 20 near-greedy steps from rows at
    different ages with one stopped, the conv state within 1e-5 of its
    peak, and logits within 1e-5 of the plain step's. Text of 100 keys: the
    attention runs in 4 key chunks at B = 1 and 3, in one at B = 8."""
    cfg = SoproTTSConfig(**CFG)
    tree = W.init_sopro_params(5, cfg, TEXT_VOCAB)
    W.fill_zero_inits(tree, None, 6)
    model = W.sopro_params_from_jax(tree, cfg, "cpu")
    g = torch.Generator().manual_seed(2 + b)
    txt = torch.randn(b, 100, cfg.d_model, generator=g)
    mask = torch.stack([torch.arange(100) < (90, 9, 100, 1, 43, 5, 67, 2)[i] for i in range(b)])
    cond = torch.randn(b, 36, cfg.d_model, generator=g) * 0.1
    with torch.no_grad():
        ctx = M.ar_context(model, txt, mask)
        part = _PartitionedStep(ctx, model.ar.stacked(), cfg, blocks)
    assert key_chunks(blocks, b, TEXT_HEADS, 100) == (4 if b < 8 else 1)

    greedy = torch.tensor([1e-4 * (1 + i) for i in range(b)])
    sett = M.ARSettings(temperature=greedy, recovery_temp=greedy, anti_loop=False,
                        min_gen_frames=torch.tensor([1 + 5 * i for i in range(b)])).per_row(b, "cpu")
    rng = np.random.default_rng(b)
    start = _rows_state(cfg, b, 36, rng)
    with torch.no_grad():
        want, ws = ar_loop_plain(ctx, cond, dict(start), sett, 20, False)
        got, gs = ar_loop_plain(part, cond, dict(start), sett, 20, False)
    assert torch.equal(got, want)
    for k in ("t", "last", "streak", "stopped", "first_eos", "key", "hist"):
        assert torch.equal(gs[k], ws[k]), k
    peak = float(ws["bufs"].abs().max())
    assert float((gs["bufs"] - ws["bufs"]).abs().max()) <= 1e-5 * peak
    assert part.calls > 2 and bool((ws["t"] > start["t"]).any())
    x = torch.randn(b, cfg.d_model, generator=g)
    with torch.no_grad():
        lg_part, lg_plain = part.step(x, ws["bufs"])[0], ctx.step(x, ws["bufs"])[0]
    assert float((lg_part - lg_plain).abs().max()) <= 1e-5 * float(lg_plain.abs().max())
