"""The numerical design of kernels K2 and K3 on the CPU (no kernel runs
here): the TF32 split of `csrc/tf32x3.cuh` emulated in torch, why three
passes are needed, why each chunk of K is summed in its own accumulator
(the tensor cores truncate), the hi/lo weight layouts that
`pack_nar_heads` and `pack_seanet_decoder` give the kernels, and a
tile-with-halo emulation of K3's launches (the fused residual-block
kernel's time tiles, halos and batch rows included) against `seanet_apply`
and the JAX package's Pallas vocoder in interpret mode.

Tolerances: hi + lo adds back to float32 within 2^-22 of |x| (by
construction of the split); the 3-pass product within 1e-6 of the peak of a
float64 product, a single TF32 pass not within 1e-4 (a TF32 operand keeps
11 significant bits); chunked truncating accumulation within 1e-6 of peak;
the emulated decode within 1e-5 of the waveform's peak of `seanet_apply`
and 1e-4 of JAX's (float32, different summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sopro_tpu.codec.convert import init_mimi_params as j_init_mimi
from sopro_tpu.codec.mimi_config import MimiConfig as JMimiCfg
from sopro_tpu.codec.pallas_vocoder import pack_seanet_decoder as j_pack, seanet_decode_pallas

from sopro_tpu_torch import weights as W
from sopro_tpu_torch.codec.mimi import seanet_apply
from sopro_tpu_torch.codec.mimi_config import MimiConfig, decoder_plan
from sopro_tpu_torch.codec.vocoder import RESBLOCK_TILE_ROWS, pack_seanet_decoder
from sopro_tpu_torch.ops.nar_heads import nar_heads_argmax_plain, pack_nar_heads
from sopro_tpu_torch.ops.tf32x3 import split_tf32, tf32_round

from tests.test_torch_streaming import PALLAS_MIMI

torch.set_num_threads(1)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def test_tf32_round_is_rna_on_the_bits():
    """cvt.rna.tf32.f32: low 13 bits cleared, nearest, ties away from zero."""
    one = torch.tensor([1.0], dtype=torch.float32)
    ulp = 2.0 ** -10  # TF32's 10-bit mantissa at 1.0
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2 ** -23,
                      1.0 + 1.5 * ulp, 3.0e-3, float("inf")], dtype=torch.float32)
    got = tf32_round(x)
    assert got[0] == 1.0 + ulp and got[1] == -(1.0 + ulp)  # ties away from zero
    assert got[2] == 1.0 and got[3] == 1.0 + 2 * ulp and torch.isinf(got[5])
    assert int((_bits(got[:5]) & 0x1FFF).abs().sum()) == 0
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(10_000).astype(np.float32))
    rel = ((tf32_round(r) - r).abs() / r.abs()).max()
    assert float(rel) <= 2.0 ** -11 and tf32_round(one) == one


def test_split_adds_back_within_2_pow_minus_22():
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(100_000).astype(np.float32) * 7)
    hi, lo = split_tf32(r)
    assert int((_bits(hi) & 0x1FFF).abs().sum()) == 0 and int((_bits(lo) & 0x1FFF).abs().sum()) == 0
    err = (hi.double() + lo.double() - r.double()).abs() / r.double().abs()
    assert float(err.max()) <= 2.0 ** -22


@pytest.mark.parametrize("k", [256, 3584, 2048])
def test_three_passes_reach_float32_one_pass_does_not(k):
    """K = 256 (K2's depth), 3,584 (the k7 conv's 7 x 512) and 2,048 (the
    x8 transpose's 2 x 1024). Every product of two TF32 values is exact in
    float32, so float32 matmuls of the parts emulate the tensor core."""
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.standard_normal((64, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, 128)).astype(np.float32))
    ref = a.double() @ b.double()
    peak = float(ref.abs().max())
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    three = al @ bh + ah @ bl + ah @ bh
    one = ah @ bh
    assert float((three.double() - ref).abs().max()) <= 1e-6 * peak
    assert float((one.double() - ref).abs().max()) > 1e-4 * peak


def _round_toward_zero(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    r = x64.float()
    return torch.where(r.double().abs() > x64.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


@pytest.mark.parametrize("k", [384, 2048])
def test_chunked_accumulation_stops_the_truncation_drift(k):
    """The tensor cores add each MMA's eight exact TF32 products to the
    float32 accumulator and truncate the sum. Emulated here: one accumulator
    through all k / 8 x 3 MMAs drifts toward zero by up to an ulp per MMA,
    ~2e-5 of peak at K = 2,048 (the x8 transpose's depth), which is what the
    first build of K3 showed on the card against float64; summing each
    16-deep chunk in a fresh accumulator and adding the chunks in
    round-to-nearest float32 (`tf32x3::add`) stays at float32's error.
    K = 384 is the fused stage-3 block's k3 conv."""
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.standard_normal((64, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, 64)).astype(np.float32))
    ref = a.double() @ b.double()
    peak = float(ref.abs().max())
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    chain, acc = torch.zeros(64, 64), torch.zeros(64, 64)
    for c0 in range(0, k, 16):
        part = torch.zeros(64, 64)
        for k0 in (c0, c0 + 8):
            for x, y in ((al, bh), (ah, bl), (ah, bh)):  # the kernels' order: small terms first
                prod = x[:, k0:k0 + 8].double() @ y[k0:k0 + 8].double()
                chain = _round_toward_zero(chain.double() + prod)
                part = _round_toward_zero(part.double() + prod)
        acc = acc + part
    chain_err = float((chain.double() - ref).abs().max())
    chunked_err = float((acc.double() - ref).abs().max())
    assert chunked_err <= 1e-6 * peak
    assert chain_err > 5 * chunked_err


def test_pack_nar_heads_layout():
    """hi and lo [H, kp, vp]: hd padded to a multiple of 16, V to 256, zeros
    in the padding, hi + lo = W within 2^-22; the kernel's arithmetic
    (3 passes on the packed parts, bias in float32, first maximum) gives
    the plain version's ids."""
    rng = np.random.default_rng(2)
    h, hd, v = 3, 40, 300
    w = torch.from_numpy(rng.standard_normal((h, hd, v)).astype(np.float32) * 0.05)
    p = pack_nar_heads(w)
    assert p["hi"].shape == p["lo"].shape == (h, 48, 512)
    assert float(p["hi"][:, hd:].abs().max()) == 0 and float(p["hi"][:, :, v:].abs().max()) == 0
    assert float(p["lo"][:, hd:].abs().max()) == 0 and float(p["lo"][:, :, v:].abs().max()) == 0
    back = p["hi"][:, :hd, :v].double() + p["lo"][:, :hd, :v].double()
    assert float(((back - w.double()).abs() / w.double().abs().clamp_min(1e-30)).max()) <= 2.0 ** -22
    z = torch.from_numpy(rng.standard_normal((2, 7, hd)).astype(np.float32))
    hid = torch.from_numpy(rng.standard_normal((h, hd)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal((h, v)).astype(np.float32) * 0.05)
    a = F.pad(z[:, :, None, :] + hid[None, None], (0, 48 - hd))  # [B, T, H, kp]
    ah, al = split_tf32(a)
    logits = (torch.einsum("bthk,hkv->bthv", al, p["hi"]) + torch.einsum("bthk,hkv->bthv", ah, p["lo"])
              + torch.einsum("bthk,hkv->bthv", ah, p["hi"]))[..., :v] + bias[None, None]
    assert torch.equal(torch.argmax(logits, -1).to(torch.int32),
                       nar_heads_argmax_plain(z, hid, w, bias))


@pytest.fixture(scope="module")
def pallas_mimi():
    """PALLAS_MIMI (full SEANet widths, hidden 32): JAX and torch weights."""
    jm, tm = JMimiCfg(**PALLAS_MIMI), MimiConfig(**PALLAS_MIMI)
    tree = jax.tree.map(np.array, j_init_mimi(4, jm))
    W.fill_zero_inits(None, tree, 5)
    dec = W.to_torch(tree["decoder"], "cpu")
    for p in dec:  # audible: std 1/sqrt(fan-in), so the waveform follows emb
        for leaf in ([p] if "w" in p else p.get("convs", [])):
            if "w" in leaf:
                leaf["w"] = leaf["w"] / leaf["w"].std() / np.sqrt(leaf["w"].shape[0] * leaf["w"].shape[1])
    return jm, tm, dec


def test_pack_seanet_decoder_layout(pallas_mimi):
    """K3's launches: the k7 conv, per stage a transpose as one two-tap conv
    over phase-major columns, stages 1-2 residual blocks as two convs,
    stages 3-4 as fused blocks (the last with the final conv); every hi/lo
    pair adds back to the weight it packs within 2^-22."""
    _, tm, dec = pallas_mimi
    packed = pack_seanet_decoder(dec, tm)
    kinds = [(x["kind"], x.get("taps"), x.get("c"), x.get("final")) for x in packed["k3"]]
    assert kinds == [("conv", 7, None, None), ("conv", 2, None, None), ("conv", 3, None, None),
                     ("conv", 1, None, None), ("conv", 2, None, None), ("conv", 3, None, None),
                     ("conv", 1, None, None), ("conv", 2, None, None), ("resblock", None, 128, False),
                     ("conv", 2, None, None), ("resblock", None, 64, True)]

    def adds_back(hi, lo, w):
        err = (hi.double() + lo.double() - w.double()).abs()
        assert float((err - 2.0 ** -22 * w.double().abs()).max()) <= 0

    up = dec[2]["w"]  # the x8 transpose, [16, 1024, 512]
    x8 = packed["k3"][1]
    assert x8["hi"].shape == (2, 1024, 8 * 512) and x8["n"] == 8 * 512
    for r in (0, 5):  # column r * Cout + c: phase r, taps [w[s-1-r], w[2s-1-r]]
        for j, k in ((0, 7 - r), (1, 15 - r)):
            cols = slice(r * 512, (r + 1) * 512)
            adds_back(x8["hi"][j, :, cols], x8["lo"][j, :, cols], up[k])
    assert torch.equal(x8["b"][512:1024], dec[2]["b"])
    last = packed["k3"][-1]
    res4 = dec[-3]["convs"]
    adds_back(last["w1hi"], last["w1lo"], res4[0]["w"].reshape(3 * 64, 32))
    adds_back(last["w2hi"], last["w2lo"], res4[1]["w"].reshape(32, 64))
    assert torch.equal(last["wf"], dec[-1]["w"].reshape(-1))
    k7 = packed["k3"][0]
    assert k7["hi"].shape == (7, 32, 1024)  # Cin 32 is already a multiple of 32
    adds_back(k7["hi"], k7["lo"], dec[0]["w"])


def _mm3(a, hi, lo):
    """The kernels' 3-pass product of activations a [..., K] and packed
    weights [K, N]."""
    ah, al = split_tf32(a)
    return al @ hi + ah @ lo + ah @ hi


def _conv_emulated(launch, x, residual):
    """K3 (a): a causal conv from the packed hi/lo weights."""
    b, t, cin = x.shape
    xin = F.elu(x) if launch["elu_in"] else x
    xin = F.pad(xin, (0, launch["hi"].shape[1] - cin))
    y = torch.zeros((b, t, launch["hi"].shape[2]))
    for j in range(launch["taps"]):
        shift = (launch["taps"] - 1 - j) * launch["dil"]
        y = y + _mm3(F.pad(xin, (0, 0, shift, 0))[:, :t], launch["hi"][j], launch["lo"][j])
    y = (y[..., :launch["n"]] + launch["b"]).reshape(b, t * launch["phases"], -1)
    return y if residual is None else y + residual


def _resblock_emulated(launch, x, tiles_seen):
    """K3 (b) tile by tile as the kernel runs it: per batch row, tiles of
    BM rows of hidden (BM - 2 output rows with the final conv), each from a
    window of BM + 2 input rows that starts 2 (+ 2) rows before the tile,
    rows before t = 0 read as zero, the last tile ragged."""
    b, t, c = x.shape
    bm = RESBLOCK_TILE_ROWS[c]
    hf = 2 if launch["final"] else 0
    bmo = bm - hf
    out = torch.zeros((b, t) if launch["final"] else (b, t, c))
    for bi in range(b):
        for t0 in range(0, t, bmo):
            tx0 = t0 - hf - 2
            rows = torch.arange(tx0, tx0 + bm + 2)
            ok = (rows >= 0) & (rows < t)
            win = torch.where(ok[:, None], x[bi, rows.clamp(0, t - 1)], torch.zeros(()))
            ex = F.elu(win)
            hidden = sum(_mm3(ex[j:j + bm], launch["w1hi"][j * c:(j + 1) * c],
                              launch["w1lo"][j * c:(j + 1) * c]) for j in range(3)) + launch["b1"]
            blk = _mm3(F.elu(hidden), launch["w2hi"], launch["w2lo"]) + launch["b2"] + win[2:]
            n = min(bmo, t - t0)
            tiles_seen.append((c, bi, t0, n))
            if not launch["final"]:
                out[bi, t0:t0 + n] = blk[:n]
                continue
            tb = torch.arange(t0 - hf, t0 - hf + bm)
            e = torch.where((tb >= 0)[:, None], F.elu(blk), torch.zeros(()))
            wf = launch["wf"].reshape(3, c)
            wav = sum(e[j:j + bmo] @ wf[j] for j in range(3)) + launch["bf"]
            out[bi, t0:t0 + n] = wav[:n]
    return out


def _emulate_k3(packed, emb, tiles):
    x, block_in = emb, None
    for launch in packed["k3"]:
        if launch["kind"] == "resblock":
            x = _resblock_emulated(launch, x, tiles)
        elif launch["residual"]:
            x = _conv_emulated(launch, x, block_in)
        else:
            block_in = x
            x = _conv_emulated(launch, x, None)
    return x


def test_k3_tile_emulation_matches_seanet_apply_and_jax(pallas_mimi):
    """emb [2, 3, 32] -> 2 x 2,880 samples: stage 3 runs 720 rows per batch
    row (22 full 32-row tiles and a ragged one of 16), stage 4 2,880 rows
    (46 tiles of 62 output rows and a ragged one of 28); batch row 1's
    first tile would read row 0's last rows if its halo crossed the row.
    Against `seanet_apply` with the filled (nonzero) biases; against JAX
    with the biases zeroed, because the JAX kernel pads the embeddings with
    zero frames, which equal the causal padding only then (ROADMAP C)."""
    jm, tm, dec = pallas_mimi
    emb = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 3, 32)).astype(np.float32))
    tiles = []
    x = _emulate_k3(pack_seanet_decoder(dec, tm), emb, tiles)
    assert x.shape == (2, 2880)
    assert (128, 1, 0, 32) in tiles and (128, 0, 704, 16) in tiles
    assert (64, 1, 0, 62) in tiles and (64, 0, 2852, 28) in tiles
    want = seanet_apply(dec, decoder_plan(tm), emb)[..., 0]
    peak = float(want.abs().max())
    assert peak > 1e-2
    assert float((x - want).abs().max()) <= 1e-5 * peak

    dec0 = [{k: (torch.zeros_like(v) if k == "b" else v) for k, v in p.items()} for p in dec]
    for p in dec0:
        if "convs" in p:
            p["convs"] = [dict(c, b=torch.zeros_like(c["b"])) for c in p["convs"]]
    x0 = _emulate_k3(pack_seanet_decoder(dec0, tm), emb, [])
    jdec0 = jax.tree.map(lambda a: jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a, dec0)
    jax_wav = np.asarray(seanet_decode_pallas(j_pack(jdec0, jm), jm, jnp.asarray(emb.numpy()),
                                              interpret=True))
    peak0 = float(np.abs(jax_wav).max())
    assert peak0 > 1e-2
    assert float(np.abs(x0.numpy() - jax_wav).max()) <= 1e-4 * peak0
