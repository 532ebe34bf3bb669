"""Kernel K4's launch plan on the CPU (no kernel runs here): the streaming
chunk decoded through K3's launch list in valid mode, with each launch
emulated in torch as `csrc/seanet.cu` computes it -- 3-pass TF32 products
(tests/test_torch_tf32x3.py), the conv kernel's Cin chunks summed in a
fresh accumulator each and its split-K partials added in rank order, the
fused residual block tile by tile with its input window, per-row stream
starts and the last launch keeping only the chunk's samples -- driven by
the port's own `run_launches` and `chunk_starts`.

Held against `seanet_decode_chunk_plain` (any history) within 1e-5 of the
waveform's peak, and against the JAX package's
`seanet_decode_pallas_chunk(interpret=True)` where the history is all real
within 1e-4 (float32 stacks in different orders; with a shorter history the
JAX kernel's zero history is not the causal padding, ROADMAP C). At
SMALL_MIMI widths every launch is a conv (the last one the final conv);
PALLAS_MIMI has the production widths, so its stages 3-4 run the fused
blocks.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sopro_tpu.codec.convert import init_mimi_params as j_init_mimi
from sopro_tpu.codec.mimi_config import MimiConfig as JMimiCfg
from sopro_tpu.codec.pallas_vocoder import pack_seanet_decoder as j_pack, seanet_decode_pallas_chunk

from sopro_tpu_torch import weights as W
from sopro_tpu_torch.codec import vocoder as V
from sopro_tpu_torch.codec.mimi_config import MimiConfig, required_halo
from sopro_tpu_torch.ops.tf32x3 import split_tf32

from tests.test_torch_cuda import SMALL_MIMI
from tests.test_torch_streaming import PALLAS_MIMI

torch.set_num_threads(1)

BKC = {1: 32, 2: 16, 3: 8, 7: 8}  # Cin per chunk of the conv kernel, by taps (sopro_seanet_conv_tc)


def _mm3(a, hi, lo):
    ah, al = split_tf32(a)
    return al @ hi + ah @ lo + ah @ hi


def _masked(x, start):
    """Rows of each batch row before its start read as zero."""
    if start is None:
        return x
    rows = torch.arange(x.shape[1])
    return torch.where((rows[None, :] >= start.long()[:, None])[..., None], x, torch.zeros(()))


def _emulated_conv(splits):
    def conv(launch, x, residual, start=None, t_out=None, max_splits=1, stream=None):
        b, t_in, cin = x.shape
        t_out = t_in if t_out is None else t_out
        taps, dil, halo = launch["taps"], launch["dil"], (launch["taps"] - 1) * launch["dil"]
        xin = _masked(x, start)
        xin = F.elu(xin) if launch["elu_in"] else xin
        xin = F.pad(F.pad(xin, (0, launch["hi"].shape[1] - cin)), (0, 0, halo, 0))
        a0 = t_in - t_out  # output row t is the causal conv at input row a0 + t
        taps_in = [xin[:, a0 + j * dil: a0 + j * dil + t_out] for j in range(taps)]
        bkc = BKC[taps]
        nc = launch["hi"].shape[1] // bkc
        s = 1
        while 2 * s <= min(splits, max_splits) and 2 * s <= nc:
            s *= 2
        total = None
        for rank in range(s):  # each rank: fresh accumulator per chunk, added in order
            acc = torch.zeros((b, t_out, launch["hi"].shape[2]))
            for c in range(rank * nc // s, (rank + 1) * nc // s):
                ks = slice(c * bkc, (c + 1) * bkc)
                acc = acc + sum(_mm3(taps_in[j][..., ks], launch["hi"][j, ks], launch["lo"][j, ks])
                                for j in range(taps))
            total = acc if total is None else total + acc  # rank order
        y = total[..., :launch["n"]] + launch["b"]
        if residual is not None:
            y = y + residual[:, residual.shape[1] - t_out:]
        conv.calls.append(s)
        return y.reshape(b, t_out * launch["phases"], launch["n"] // launch["phases"])

    conv.calls = []
    return conv


def _emulated_resblock(launch, x, start=None, t_out=None, stream=None):
    """The fused block tile by tile: BM rows of hidden (BM - 2 output rows
    with the final conv) from a window of BM + 2 input rows starting at input
    row a0 + t0 - HF - 2; input rows before the start (or past T_in) and the
    final conv's input rows before it read as zero; the last tile ragged."""
    b, t_in, c = x.shape
    t_out = t_in if t_out is None else t_out
    bm = V.RESBLOCK_TILE_ROWS[c]
    hf = 2 if launch["final"] else 0
    bmo, a0 = bm - hf, t_in - t_out
    out = torch.zeros((b, t_out) if launch["final"] else (b, t_out, c))
    for bi in range(b):
        lo = 0 if start is None else int(start[bi])
        for t0 in range(0, t_out, bmo):
            rows = torch.arange(a0 + t0 - hf - 2, a0 + t0 - hf + bm)
            ok = (rows >= lo) & (rows < t_in)
            win = torch.where(ok[:, None], x[bi, rows.clamp(0, t_in - 1)], torch.zeros(()))
            ex = F.elu(win)
            hidden = sum(_mm3(ex[j:j + bm], launch["w1hi"][j * c:(j + 1) * c],
                              launch["w1lo"][j * c:(j + 1) * c]) for j in range(3)) + launch["b1"]
            blk = _mm3(F.elu(hidden), launch["w2hi"], launch["w2lo"]) + launch["b2"] + win[2:]
            n = min(bmo, t_out - t0)
            if not launch["final"]:
                out[bi, t0:t0 + n] = blk[:n]
                continue
            anchor = torch.arange(a0 + t0 - hf, a0 + t0 - hf + bm)
            e = torch.where((anchor >= lo)[:, None], F.elu(blk), torch.zeros(()))
            wf = launch["wf"].reshape(3, c)
            out[bi, t0:t0 + n] = (sum(e[j:j + bmo] @ wf[j] for j in range(3)) + launch["bf"])[:n]
    return out


@pytest.fixture(scope="module", params=["small", "pallas"])
def decoder(request):
    """(JAX cfg, port cfg, torch decoder params with filled biases, audible
    weights: std 1/sqrt(fan-in), so the waveform follows ext)."""
    widths = SMALL_MIMI if request.param == "small" else PALLAS_MIMI
    jm, tm = JMimiCfg(**widths), MimiConfig(**widths)
    tree = jax.tree.map(np.array, j_init_mimi(8, jm))
    W.fill_zero_inits(None, tree, 9)
    dec = W.to_torch(tree["decoder"], "cpu")
    for p in dec:
        for leaf in ([p] if "w" in p else p.get("convs", [])):
            if "w" in leaf:
                leaf["w"] = leaf["w"] / leaf["w"].std() / np.sqrt(leaf["w"].shape[0] * leaf["w"].shape[1])
    return request.param, jm, tm, dec


def _decode_emulated(monkeypatch, packed, tm, ext, n_hist, splits):
    conv = _emulated_conv(splits)
    monkeypatch.setattr(V, "_conv_cuda", conv)
    monkeypatch.setattr(V, "_resblock_cuda", _emulated_resblock)
    monkeypatch.setattr(V.kernels, "stream_ptr", lambda device: ctypes.c_void_p(0))
    n_out = (ext.shape[1] - required_halo(tm)) * int(np.prod(tm.upsampling_ratios))
    wav = V.run_launches(packed["k3"], ext, V.chunk_starts(packed, tm, n_hist, ext.device),
                         keep=n_out, valid=True)
    return wav, conv.calls


@pytest.mark.parametrize("m25", [4, 12])  # chunks of 2 and 6 AR frames
@pytest.mark.parametrize("hist", [(0,), (3,), None, (0, 3), (8, 0)])
def test_chunk_launch_list_matches_plain(monkeypatch, decoder, m25, hist):
    """B = 1 and 2, n_hist 0, 3 and the whole halo (None, or 8 = halo),
    convs split over 16 cluster ranks where they have the chunks."""
    name, _, tm, dec = decoder
    packed = V.pack_seanet_decoder(dec, tm)
    halo = required_halo(tm)
    b = 1 if hist is None or len(hist) == 1 else 2
    ext = torch.from_numpy(np.random.default_rng(m25 + b).standard_normal(
        (b, halo + m25, tm.hidden_size)).astype(np.float32))
    n_hist = None if hist is None else torch.tensor([min(h, halo) for h in hist], dtype=torch.int32)
    got, splits = _decode_emulated(monkeypatch, packed, tm, ext, n_hist, splits=16)
    want = V.seanet_decode_chunk_plain(packed["params"], tm, ext, n_hist)
    assert got.shape == want.shape == (b, m25 * int(np.prod(tm.upsampling_ratios)))
    peak = float(want.abs().max())
    assert peak > 1e-2
    assert float((got - want).abs().max()) <= 1e-5 * peak
    assert max(splits) == (16 if name == "pallas" else 4)  # the split-K order ran
    kinds = [x["kind"] for x in packed["k3"]]
    assert len(kinds) <= 11 and kinds.count("resblock") == (2 if name == "pallas" else 0)


@pytest.mark.parametrize("splits", [1, 4])
def test_chunk_split_counts_agree(monkeypatch, decoder, splits):
    """Any split count the launch may pick (it depends on the card's SMs and
    cluster occupancy) sums to the same waveform within 1e-5 of peak."""
    _, _, tm, dec = decoder
    packed = V.pack_seanet_decoder(dec, tm)
    ext = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, required_halo(tm) + 12, tm.hidden_size)).astype(np.float32))
    n_hist = torch.tensor([2, required_halo(tm)], dtype=torch.int32)
    got, _ = _decode_emulated(monkeypatch, packed, tm, ext, n_hist, splits)
    want = V.seanet_decode_chunk_plain(packed["params"], tm, ext, n_hist)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("decoder", ["pallas"], indirect=True)
@pytest.mark.parametrize("b,m25", [(1, 4), (2, 12)])
def test_chunk_launch_list_matches_jax_with_real_history(monkeypatch, decoder, b, m25):
    """All halo rows real: the emulated launch list against the JAX Pallas
    chunk kernel in interpret mode (production widths only: the TPU kernel
    needs 2 * num_filters to fill its 128 lanes)."""
    _, jm, tm, dec = decoder
    packed = V.pack_seanet_decoder(dec, tm)
    ext = np.random.default_rng(b * 10 + m25).standard_normal(
        (b, required_halo(tm) + m25, tm.hidden_size)).astype(np.float32)
    got, _ = _decode_emulated(monkeypatch, packed, tm, torch.from_numpy(ext), None, splits=16)
    jdec = jax.tree.map(lambda a: jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a, dec)
    want = np.asarray(seanet_decode_pallas_chunk(j_pack(jdec, jm), jm, jnp.asarray(ext),
                                                 interpret=True))
    peak = float(np.abs(want).max())
    assert peak > 1e-2
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4 * peak
