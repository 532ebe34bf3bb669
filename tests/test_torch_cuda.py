"""The five CUDA kernels against their plain PyTorch versions on the card,
at small shapes; the synthesize, batch, per-step and stream paths and a
training step on the card against the CPU; the tp = 2 training step on
`cuda:0` against the unsharded one; serving after a training step
from rebuilt weight packs; every kernel launched on tensors of another card
than the current one, and serving and batch synthesis over a mesh against
one shard. Each test skips without a CUDA device (the launch-device test
also with fewer than 2 cards).

This file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

It also holds the small configurations and the training batch the other
test_torch_* files share.
Tolerances on the card: ids and tokens exact (argmax and sampler decisions
away from near-ties), waveforms within 1e-4 of their peak (fp32, summation
order differs from cuBLAS/cuDNN). The bfloat16 instantiations are held
against their bfloat16 plain versions at the bars stated above their tests.
"""

import numpy as np
import pytest
import torch

from sopro_tpu_torch import kernels
from sopro_tpu_torch import weights as W
from sopro_tpu_torch.codec.mimi_config import MimiConfig
from sopro_tpu_torch.config import SoproTTSConfig

# shapes of tests/test_model_parity.py and tests/test_mimi_streaming.py
CFG = dict(
    num_codebooks=8, codebook_size=32, max_frames=20, d_model=64,
    n_layers_text=1, dropout=0.0, pos_emb_max=64, max_text_len=32,
    n_layers_ar=2, ar_kernel=5, ar_dilation_cycle=(1, 2), ar_text_attn_freq=2,
    min_gen_frames=3, n_layers_nar=2, nar_head_dim=32, nar_kernel_size=5,
    nar_dilation_cycle=(1, 2), stage_B=(2, 3), stage_C=(4, 5), stage_D=(6, 7),
    stage_E=(8, 8), sv_student_dim=16, ref_enc_layers=1, ref_xattn_heads=2,
    ref_xattn_layers=2,
)
# codebook count/size match CFG so Sopro tokens decode through this Mimi
SMALL_MIMI = dict(
    hidden_size=32, num_filters=4, upsampling_ratios=(4, 3), codebook_size=32,
    codebook_dim=8, num_quantizers=8, vector_quantization_hidden_dimension=8,
    num_semantic_quantizers=1, upsample_groups=32, num_hidden_layers=2,
    intermediate_size=64, num_attention_heads=2, num_key_value_heads=2,
    head_dim=16, sliding_window=6, frame_rate=1000.0,
)
TEXT_VOCAB = 259  # SimpleCharTokenizer
# training: the configuration of tests/test_parallel.py
TRAIN_CFG = dict(
    d_model=64, n_layers_text=1, n_layers_ar=2, n_layers_nar=2, ref_enc_layers=1,
    ref_xattn_layers=1, max_frames=16, num_codebooks=8, codebook_size=32, nar_head_dim=32,
    stage_B=(2, 3), stage_C=(4, 5), stage_D=(6, 7), stage_E=(8, 8), sv_student_dim=16,
)


def make_batch(seed=0, b=4, l=10, tr=6, s=12, vocab=64, cb=32, q=8):
    """A numpy training batch for TRAIN_CFG: frame lengths (s, 7, 4, 9) (row
    0 fills S: no EOS target), partial text and reference masks."""
    rng = np.random.default_rng(seed)
    lengths = np.array([s, 7, 4, 9][:b])
    return dict(
        text_ids=rng.integers(0, vocab, (b, l)).astype(np.int32),
        text_mask=np.arange(l)[None] < np.array([l, 6, 8, 3][:b])[:, None],
        ref_tokens=rng.integers(0, cb, (b, tr, q)).astype(np.int32),
        ref_mask=np.arange(tr)[None] < np.array([tr, 4, 5, 6][:b])[:, None],
        frames=rng.integers(0, cb, (b, s, q)).astype(np.int32),
        frame_mask=np.arange(s)[None] < lengths[:, None],
    )


def torch_batch(nb, device="cpu"):
    from sopro_tpu_torch.train import TrainBatch

    return TrainBatch(**{k: torch.from_numpy(v).to(device) for k, v in nb.items()})


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sopro_tpu_torch.engine import configure_cuda_numerics

    configure_cuda_numerics()
    return torch.device("cuda")


def _tts_pair(dev, runtime=None):
    """The same random small model on the CPU and on `dev`."""
    from sopro_tpu_torch.engine import Engine
    from sopro_tpu_torch.tokenizer import SimpleCharTokenizer
    from sopro_tpu_torch.tts import SoproTTS

    cfg, mcfg = SoproTTSConfig(**CFG), MimiConfig(**SMALL_MIMI)
    tree, mtree = W.init_sopro_params(5, cfg, TEXT_VOCAB), W.init_mimi_params(5, mcfg)
    W.fill_zero_inits(tree, mtree, 6)
    return [
        SoproTTS(Engine(W.sopro_params_from_jax(tree, cfg, d),
                        W.mimi_params_from_jax(mtree, mcfg, d), runtime), cfg,
                 SimpleCharTokenizer(), runtime)
        for d in ("cpu", dev)
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,hd,v", [
    (2, 37, 3, 64, 256), (1, 401, 16, 256, 2048), (1, 9, 2, 8, 130),
    (1, 6, 16, 256, 2048),  # the stream's last stage: head_tail = 6 frames
])
def test_nar_heads_kernel_matches_plain(cuda, b, t, h, hd, v):
    from sopro_tpu_torch.ops.nar_heads import nar_heads_argmax, nar_heads_argmax_plain

    g = torch.Generator().manual_seed(b * 1000 + t)
    z, hid = torch.randn(b, t, hd, generator=g), torch.randn(h, hd, generator=g)
    w = torch.randn(h, hd, v, generator=g) * 0.05
    bias = torch.randn(h, v, generator=g) * 0.05
    w[:, :, 70 % v] = w[:, :, 7]
    bias[:, 7] = bias[:, 70 % v] = 50.0  # an exact tie far above the rest: lowest index wins
    args = [x.to(cuda) for x in (z, hid, w, bias)]
    got = nar_heads_argmax(*args)
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, t, h)
    assert torch.equal(got.cpu(), nar_heads_argmax_plain(*args).cpu())
    assert torch.all(got == 7)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [6, 187, 401, 1604])
@pytest.mark.parametrize("h", [3, 16])
def test_nar_heads_kernel_main_path_rows(cuda, rows, h):
    """K2 at the main paths' row counts (stream stage E, stream window, one
    request, a B = 4 batch) and widths (hd 256, V 2048), H = 3 and 16, with
    the packed weights: ids equal the plain version's wherever the top-2
    margin exceeds 1e-5, and an exact tie planted in head 0 goes to the
    lowest index."""
    from sopro_tpu_torch.ops.nar_heads import (
        nar_heads_argmax, nar_heads_argmax_plain, pack_nar_heads,
    )

    g = torch.Generator().manual_seed(rows + h)
    z, hid = torch.randn(1, rows, 256, generator=g), torch.randn(h, 256, generator=g) * 0.1
    w = torch.randn(h, 256, 2048, generator=g) * 0.02
    bias = torch.randn(h, 2048, generator=g) * 0.02
    w[0, :, 1500] = w[0, :, 300]
    bias[0, 300] = bias[0, 1500] = 30.0
    z, hid, w, bias = (x.to(cuda) for x in (z, hid, w, bias))
    before = kernels.LAUNCHES["nar_heads"]
    got = nar_heads_argmax(z, hid, w, bias, pack_nar_heads(w))
    assert kernels.LAUNCHES["nar_heads"] == before + 1
    want = nar_heads_argmax_plain(z, hid, w, bias)
    logits = torch.einsum("bthd,hdv->bthv", z[:, :, None] + hid[None, None], w) + bias[None, None]
    top2 = torch.topk(logits, 2, dim=-1).values
    differ = got != want
    assert not bool((differ & (top2[..., 0] - top2[..., 1] > 1e-5)).any())
    assert bool((got[..., 0] == 300).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2])
def test_seanet_kernel_full_width(cuda, b):
    """K3 at full Mimi width (802 25 Hz rows -> 769,920 samples per row):
    the tensor-core convs and the fused residual blocks of the 128- and
    64-channel stages, within 1e-4 of peak of the float32 plain version and
    of a float64 one. 3-pass TF32 reads ~1e-5 of peak against float64 on
    the H100, 20x the float32 stack's error: the tensor cores' float32
    accumulation does not round to nearest."""
    from sopro_tpu_torch.codec.mimi import seanet_apply
    from sopro_tpu_torch.codec.mimi_config import decoder_plan
    from sopro_tpu_torch.codec.vocoder import pack_seanet_decoder, seanet_decode
    from sopro_tpu_torch.models.base import tree_map

    mcfg = MimiConfig()
    mtree = W.init_mimi_params(3, mcfg)
    W.fill_zero_inits(None, mtree, 4)
    dec = W.to_torch(mtree["decoder"], cuda)
    packed = pack_seanet_decoder(dec, mcfg)
    assert [x["kind"] for x in packed["k3"]].count("resblock") == 2
    emb = torch.randn(b, 802, mcfg.hidden_size, generator=torch.Generator().manual_seed(b)).to(cuda)
    got = seanet_decode(packed, mcfg, emb)
    want = seanet_apply(dec, decoder_plan(mcfg), emb)[..., 0]
    dec64 = tree_map(lambda a: a.double() if torch.is_floating_point(a) else a, dec)
    ref = seanet_apply(dec64, decoder_plan(mcfg), emb.double())[..., 0]
    assert got.shape == (b, 802 * 960)
    peak = float(ref.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * peak
    assert float((got.double() - ref).abs().max()) <= 1e-4 * peak


@pytest.mark.cuda
def test_seanet_kernel_matches_plain(cuda):
    from sopro_tpu_torch.codec.mimi import seanet_apply
    from sopro_tpu_torch.codec.mimi_config import decoder_plan
    from sopro_tpu_torch.codec.vocoder import pack_seanet_decoder, seanet_decode

    mcfg = MimiConfig(**SMALL_MIMI)
    mtree = W.init_mimi_params(3, mcfg)
    W.fill_zero_inits(None, mtree, 4)
    dec = W.to_torch(mtree["decoder"], cuda)
    emb = torch.randn(2, 13, mcfg.hidden_size, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = kernels.LAUNCHES["seanet"]
    got = seanet_decode(pack_seanet_decoder(dec, mcfg), mcfg, emb)
    want = seanet_apply(dec, decoder_plan(mcfg), emb)[..., 0]
    assert kernels.LAUNCHES["seanet"] == before + 1
    tol = 1e-4 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("b,m25,hist", [(1, 12, None), (2, 12, None), (1, 3, None),
                                        (2, 4, (0, 6)), (3, 2, (9, 1, 3))])
def test_seanet_chunk_kernel_matches_plain(cuda, b, m25, hist):
    """K4 (valid mode over [halo ++ chunk]) against its plain version, with
    nonzero biases, a full history or `hist` real history rows per batch
    row."""
    from sopro_tpu_torch.codec.mimi_config import required_halo
    from sopro_tpu_torch.codec.vocoder import pack_seanet_decoder, seanet_decode_chunk

    mcfg = MimiConfig(**SMALL_MIMI)
    mtree = W.init_mimi_params(3, mcfg)
    W.fill_zero_inits(None, mtree, 4)
    packed_gpu = pack_seanet_decoder(W.to_torch(mtree["decoder"], cuda), mcfg)
    packed_cpu = pack_seanet_decoder(W.to_torch(mtree["decoder"], "cpu"), mcfg)
    g = torch.Generator().manual_seed(b * 100 + m25)
    ext = torch.randn(b, required_halo(mcfg) + m25, mcfg.hidden_size, generator=g)
    n_hist = None if hist is None else torch.tensor(hist, dtype=torch.int32)
    before = kernels.LAUNCHES["seanet_chunk"]
    got = seanet_decode_chunk(packed_gpu, mcfg, ext.to(cuda),
                              None if n_hist is None else n_hist.to(cuda))
    assert kernels.LAUNCHES["seanet_chunk"] == before + 1
    want = seanet_decode_chunk(packed_cpu, mcfg, ext, n_hist)
    assert tuple(got.shape) == (b, m25 * 12)
    tol = 1e-4 * float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("b,m25,hist", [(1, 12, None), (2, 32, (0, 5))])
def test_seanet_chunk_kernel_is_deterministic_full_width(cuda, b, m25, hist):
    """K4 at full Mimi width (chunks of 6 and 16 AR frames), where its convs
    split Cin over a cluster and sum the partials in rank order: two calls
    are bit-identical, and within 1e-4 of peak of the plain version."""
    from sopro_tpu_torch.codec.mimi_config import required_halo
    from sopro_tpu_torch.codec.vocoder import (
        pack_seanet_decoder, seanet_decode_chunk, seanet_decode_chunk_plain,
    )

    mcfg = MimiConfig()
    mtree = W.init_mimi_params(3, mcfg)
    W.fill_zero_inits(None, mtree, 4)
    dec = W.to_torch(mtree["decoder"], cuda)
    packed = pack_seanet_decoder(dec, mcfg)
    g = torch.Generator().manual_seed(b + m25)
    ext = torch.randn(b, required_halo(mcfg) + m25, mcfg.hidden_size, generator=g).to(cuda)
    n_hist = None if hist is None else torch.tensor(hist, dtype=torch.int32, device=cuda)
    first = seanet_decode_chunk(packed, mcfg, ext, n_hist)
    again = seanet_decode_chunk(packed, mcfg, ext, n_hist)
    assert torch.equal(first, again)
    want = seanet_decode_chunk_plain(dec, mcfg, ext, n_hist)
    assert float((first - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
def test_ar_loop_kernel_at_the_largest_text_bucket(cuda):
    """K1 at full Sopro width with a 1,450-character prompt (text bucket
    2,048, the most shared memory K1 takes): it launches one block on
    every SM of the card, in one wave, and 24 near-greedy steps equal
    ar_loop_plain's tokens and state."""
    from sopro_tpu_torch.codec.mimi import MimiCodec
    from sopro_tpu_torch.engine import Engine
    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.ops.ar_loop import SMEM_PER_BLOCK, ar_loop, ar_loop_plain, smem_bytes
    from sopro_tpu_torch.tokenizer import SimpleCharTokenizer

    cfg = SoproTTSConfig()
    tree = W.init_sopro_params(0, cfg, TEXT_VOCAB)
    W.fill_zero_inits(tree, None, 1)
    eng = Engine(W.sopro_params_from_jax(tree, cfg, cuda), MimiCodec({}, None))
    text = " ".join(f"Sentence number {i} of a long prompt that fills the largest text bucket."
                    for i in range(20))
    ref = eng.prepare_reference(np.random.default_rng(0).integers(
        0, cfg.codebook_size, (150, cfg.num_codebooks)).astype(np.int32))
    with torch.inference_mode():
        prep = eng.prepare_conditioning(np.asarray(SimpleCharTokenizer().encode(text), np.int32),
                                        ref, max_frames=40, style_strength=1.0)
        assert prep["text_mask"].shape[1] == 2048
        assert smem_bytes(cfg, 2048) <= SMEM_PER_BLOCK
        ctx = M.ar_context(eng.model, prep["txt_seq"], prep["text_mask"])
        cond = prep["cond_ar"]

        def fresh():
            c = M.init_ar_carry(cfg, 1, cond.shape[1], 7, cuda)
            return {k: getattr(c, k) for k in ("t", "last", "streak", "stopped", "first_eos",
                                               "key", "hist", "bufs")}

        sett = M.ARSettings(temperature=1e-4, anti_loop=False).per_row(1, cuda)
        got, gs = ar_loop(ctx, cond, fresh(), sett, 24, False)
        info = kernels.LAUNCH_INFO["ar_loop"]
        assert info["blocks"] == info["sms"] and info["waves"] == 1 and info["row_groups"] == 1, info
        want, ws = ar_loop_plain(ctx, cond, fresh(), sett, 24, False)
    assert torch.equal(got, want)
    for k in ("t", "last", "streak", "stopped", "first_eos", "key", "hist"):
        assert torch.equal(gs[k], ws[k]), k
    assert float((gs["bufs"] - ws["bufs"]).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_ar_loop_kernel_matches_plain_and_chunks(cuda):
    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.ops.ar_loop import ar_loop, ar_loop_plain

    _, tts = _tts_pair(cuda)
    model, cfg = tts.engine.model, tts.cfg
    g = torch.Generator().manual_seed(2)
    txt = torch.randn(1, 12, cfg.d_model, generator=g).to(cuda)
    mask = (torch.arange(12) < 9)[None].to(cuda)
    cond = (torch.randn(1, 25, cfg.d_model, generator=g) * 0.1).to(cuda)
    ctx = M.ar_context(model, txt, mask)

    def fresh():
        c = M.init_ar_carry(cfg, 1, 25, 7, cuda)
        return {k: getattr(c, k) for k in ("t", "last", "streak", "stopped",
                                           "first_eos", "key", "hist", "bufs")}

    sett = M.ARSettings(temperature=1e-4, anti_loop=False)
    per_row = sett.per_row(1, cuda)
    got, gs = ar_loop(ctx, cond, fresh(), per_row, 25, False)
    want, ws = ar_loop_plain(ctx, cond, fresh(), per_row, 25, False)
    assert torch.equal(got, want)
    for k in ("t", "last", "streak", "stopped", "first_eos", "key", "hist"):
        assert torch.equal(gs[k], ws[k]), k
    assert float((gs["bufs"] - ws["bufs"]).abs().max()) < 1e-4
    # state in / state out: two chunks equal one launch
    t1, s1 = ar_loop(ctx, cond, fresh(), per_row, 9, False)
    t2, s2 = ar_loop(ctx, cond, s1, per_row, 25, False)
    assert torch.equal(torch.cat([t1, t2], 1)[:, :25], got)
    assert torch.equal(s2["t"], gs["t"]) and torch.equal(s2["hist"], gs["hist"])


@pytest.mark.cuda
@pytest.mark.parametrize("b", [2, 16, 32])
def test_ar_loop_kernel_rows_match_solo(cuda, b):
    """B rows in one launch (all rows through each product together, one
    wave) give what each row gives alone, at production settings, with rows
    stopping at different steps."""
    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.ops.ar_loop import ar_loop

    _, tts = _tts_pair(cuda)
    model, cfg = tts.engine.model, tts.cfg
    g = torch.Generator().manual_seed(3)
    txt = torch.randn(b, 12, cfg.d_model, generator=g).to(cuda)
    mask = torch.stack([torch.arange(12) < (9, 5, 12, 1)[i % 4] for i in range(b)]).to(cuda)
    cond = (torch.randn(b, 25, cfg.d_model, generator=g) * 0.1).to(cuda)
    keys = ("t", "last", "streak", "stopped", "first_eos", "key", "hist", "bufs")
    sett = M.ARSettings(min_gen_frames=4)
    both = {k: getattr(M.init_ar_carry(cfg, b, 25, 11, cuda), k) for k in keys}
    tok2, st2 = ar_loop(M.ar_context(model, txt, mask), cond, both, sett.per_row(b, cuda), 25, True)
    info = kernels.LAUNCH_INFO["ar_loop"]
    assert info["waves"] == 1 and info["row_groups"] == 1 and info["rows_per_group"] == b, info
    for i in range(b):
        one = {k: (v[:, i:i + 1] if k == "bufs" else v[i:i + 1]).contiguous() for k, v in both.items()}
        ctx = M.ar_context(model, txt[i:i + 1], mask[i:i + 1])
        tok1, st1 = ar_loop(ctx, cond[i:i + 1], one, sett.per_row(1, cuda), 25, True)
        assert torch.equal(tok1[0], tok2[i])
        assert torch.equal(st1["t"][0], st2["t"][i]) and torch.equal(st1["hist"][0], st2["hist"][i])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ar_loop_kernel_repeats_bit_for_bit(cuda, dtype):
    """Two K1 launches at B = 8 from the same state give the same tokens and
    the same state bit for bit: every sum across blocks is taken in a fixed
    order."""
    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.ops.ar_loop import ar_loop

    tts = _tts_pair(cuda)[1] if dtype == torch.float32 else _bf16_tts(cuda)
    model, cfg = tts.engine.model, tts.cfg
    g = torch.Generator().manual_seed(4)
    txt = torch.randn(8, 12, cfg.d_model, generator=g).to(cuda, dtype)
    mask = torch.stack([torch.arange(12) < 3 + i for i in range(8)]).to(cuda)
    cond = (torch.randn(8, 25, cfg.d_model, generator=g) * 0.1).to(cuda, dtype)
    ctx = M.ar_context(model, txt, mask)
    keys = ("t", "last", "streak", "stopped", "first_eos", "key", "hist", "bufs")
    start = {k: getattr(M.init_ar_carry(cfg, 8, 25, 13, cuda, dtype), k) for k in keys}
    per_row = M.ARSettings().per_row(8, cuda)
    tok1, st1 = ar_loop(ctx, cond, dict(start), per_row, 25, True)
    tok2, st2 = ar_loop(ctx, cond, dict(start), per_row, 25, True)
    assert torch.equal(tok1, tok2)
    for k in keys:
        assert torch.equal(st1[k], st2[k]), k


@pytest.mark.cuda
def test_slice_on_cuda_matches_cpu(cuda):
    """The slice runs through all three kernels and gives the CPU plain
    path's tokens at near-greedy settings; waveforms within 1e-4 of peak."""
    cpu, gpu = _tts_pair(cuda)
    ref = np.random.default_rng(12).integers(0, 32, (40, 8)).astype(np.int32)
    kw = dict(max_frames=24, seed=3, temperature=1e-4, anti_loop=False)
    text = "a second, longer request"
    kernels.reset_launches()
    got = gpu.generate_tokens(text, gpu.prepare_reference(ref_tokens_tq=ref), **kw)
    want = cpu.generate_tokens(text, cpu.prepare_reference(ref_tokens_tq=ref), **kw)
    np.testing.assert_array_equal(got, want)
    wg = gpu.synthesize(text, ref_tokens_tq=ref, **kw)
    assert all(kernels.LAUNCHES[k] > 0 for k in ("ar_loop", "nar_heads", "seanet")), kernels.LAUNCHES
    wc = cpu.synthesize(text, ref_tokens_tq=ref, **kw)
    np.testing.assert_allclose(wg, wc, atol=1e-4 * float(np.abs(wc).max()), rtol=0)


@pytest.mark.cuda
def test_stream_on_cuda_matches_cpu(cuda):
    """The stream runs through K1, K2 and K4 and gives the CPU plain path's
    chunks at near-greedy settings: same count and shapes, waveform within
    1e-4 of peak (the decoder biases are filled, so K4 also meets real
    history from the second chunk on)."""
    cpu, gpu = _tts_pair(cuda)
    ref = np.random.default_rng(12).integers(0, 32, (40, 8)).astype(np.int32)
    kw = dict(ref_tokens_tq=ref, max_frames=22, seed=3, temperature=1e-4, anti_loop=False,
              chunk_frames=4)
    kernels.reset_launches()
    got = list(gpu.stream("a streamed request", **kw))
    assert all(kernels.LAUNCHES[k] > 0 for k in ("ar_loop", "nar_heads", "seanet_chunk")), \
        kernels.LAUNCHES
    want = list(cpu.stream("a streamed request", **kw))
    assert [g.shape for g in got] == [w.shape for w in want] and len(got) > 1
    peak = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4 * peak, rtol=0)
    assert np.array_equal(_stream_tokens(gpu, ref), _stream_tokens(cpu, ref))


def _stream_tokens(tts, ref):
    """The AR tokens of a chunk-4 stream, driven through the engine."""
    eng = tts.engine
    sampling = dict(top_p=0.9, temperature=1e-4, anti_loop=False, min_gen=3)
    wav, valid, done, carry, ctx, cond, mstate = eng.stream_start_fused(
        tts.encode_text("a streamed request"), tts.prepare_reference(ref_tokens_tq=ref),
        max_frames=22, chunk=4, style_strength=1.0, seed=3, **sampling)
    while not done:
        wav, valid, done, carry, mstate = eng.stream_step_fused(
            carry, ctx, cond, mstate, valid, chunk=4, nar_ctx=tts.cfg.rf_nar(), **sampling)
    return carry.tokens.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("valid", [(9,), (12, 5), (7, 0, 12)])
def test_ar_step_kernel_matches_plain(cuda, valid):
    """K5 against its plain version at B = 1, 2, 3 with partial masks (one
    row with no valid text key), over 5 chained steps; logits and buffers
    within 1e-5 of their peak."""
    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.ops.ar_step import ar_step, ar_step_plain

    _, tts = _tts_pair(cuda)
    model, cfg = tts.engine.model, tts.cfg
    b = len(valid)
    g = torch.Generator().manual_seed(b)
    txt = torch.randn(b, 12, cfg.d_model, generator=g).to(cuda)
    mask = (torch.arange(12)[None, :] < torch.tensor(valid)[:, None]).to(cuda)
    ctx = M.ar_step_context(model, txt, mask)
    bufs = torch.randn(cfg.n_layers_ar, b, 9, cfg.d_model, generator=g).to(cuda)
    before = kernels.LAUNCHES["ar_step"]
    for _ in range(5):
        x = torch.randn(b, cfg.d_model, generator=g).to(cuda)
        (lg, bg), (lw, bw) = ar_step(ctx, x, bufs), ar_step_plain(ctx, x, bufs)
        assert lg.shape == (b, cfg.ar_vocab) and bg.shape == bufs.shape
        assert float((lg - lw).abs().max()) <= 1e-5 * float(lw.abs().max())
        assert float((bg - bw).abs().max()) <= 1e-5 * float(bw.abs().max())
        bufs = bw
    assert kernels.LAUNCHES["ar_step"] == before + 5


@pytest.mark.cuda
def test_per_step_route_on_cuda_matches_k1_route(cuda):
    """With use_pallas_resident=False a request goes through K5 and never K1,
    and at near-greedy settings gives the K1 route's tokens and waveform
    (within 1e-4 of its peak); a B = 3 batch raises."""
    from sopro_tpu_torch.config import RuntimeConfig

    _, k1 = _tts_pair(cuda)
    _, k5 = _tts_pair(cuda, RuntimeConfig(use_pallas_resident=False))
    ref = np.random.default_rng(12).integers(0, 32, (40, 8)).astype(np.int32)
    kw = dict(ref_tokens_tq=ref, max_frames=24, seed=3, temperature=1e-4, anti_loop=False)
    kernels.reset_launches()
    got = k5.synthesize("a second, longer request", **kw)
    assert kernels.LAUNCHES["ar_step"] > 0 and kernels.LAUNCHES["ar_loop"] == 0, kernels.LAUNCHES
    want = k1.synthesize("a second, longer request", **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4 * float(np.abs(want).max()), rtol=0)
    with pytest.raises(ValueError, match="use_pallas_ar"):
        k5.synthesize_batch(["a", "b", "c"], ref_tokens_tq=ref, max_frames=8)


@pytest.mark.cuda
def test_synthesize_batch_on_cuda_matches_cpu(cuda):
    """A B = 3 batch through K1, K2 and K3 gives the CPU's rows at
    near-greedy settings (lengths equal, waveforms within 1e-4 of peak)."""
    cpu, gpu = _tts_pair(cuda)
    ref = np.random.default_rng(12).integers(0, 32, (40, 8)).astype(np.int32)
    texts = ("hello there", "a second, longer request", "hello there")
    kw = dict(ref_tokens_tq=ref, max_frames=24, seeds=(3, 5, 3), temperature=1e-4,
              anti_loop=False)
    kernels.reset_launches()
    got = gpu.synthesize_batch(texts, **kw)
    assert all(kernels.LAUNCHES[k] > 0 for k in ("ar_loop", "nar_heads", "seanet")), \
        kernels.LAUNCHES
    want = cpu.synthesize_batch(texts, **kw)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4 * float(np.abs(w).max()), rtol=0)
    np.testing.assert_array_equal(got[0], got[2])


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["fused", "batch"])
def test_no_sync_between_ar_and_readback(cuda, plan, monkeypatch):
    """`torch.cuda.set_sync_debug_mode("error")` inside `sopro.nar` and
    `sopro.mimi` of a warmed-up call: the NAR and the Mimi decode queue
    behind K1 without waiting for the card (tests/test_torch_no_sync.py
    holds the same window on the CPU); the waveforms equal the call's
    without the mode."""
    import contextlib

    from sopro_tpu_torch import engine as E

    _, tts = _tts_pair(cuda)
    ref = tts.prepare_reference(
        ref_tokens_tq=np.random.default_rng(12).integers(0, 32, (40, 8)).astype(np.int32))
    say = {"fused": lambda: [tts.synthesize("hello there", ref=ref, max_frames=24, seed=3,
                                            fused=True)],
           "batch": lambda: tts.synthesize_batch(["hello there", "a second, longer request"],
                                                 ref=ref, max_frames=24, seeds=(3, 5))}[plan]
    want = say()

    @contextlib.contextmanager
    def errors_on_sync():
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")

    with pytest.raises(RuntimeError), errors_on_sync():  # the mode sees a list's copy
        torch.as_tensor([0, 1], device=cuda)
    plain = E.span

    @contextlib.contextmanager
    def span(name):
        with plain(name), (errors_on_sync() if name in ("sopro.nar", "sopro.mimi")
                           else contextlib.nullcontext()):
            yield

    monkeypatch.setattr(E, "span", span)
    kernels.reset_launches()
    got = say()
    assert all(kernels.LAUNCHES[k] > 0 for k in ("ar_loop", "nar_heads", "seanet")), \
        kernels.LAUNCHES
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_use_pallas_vocoder_off_raises_on_cuda(cuda):
    """RuntimeConfig(use_pallas_vocoder=False) has no SEANet route on the
    card: building the engine there raises."""
    from sopro_tpu_torch.config import RuntimeConfig
    from sopro_tpu_torch.tts import SoproTTS

    with pytest.raises(ValueError, match="use_pallas_vocoder"):
        SoproTTS.from_random(SoproTTSConfig(**CFG), mimi_cfg=MimiConfig(**SMALL_MIMI), device=cuda,
                             runtime=RuntimeConfig(use_pallas_vocoder=False))


@pytest.mark.cuda
def test_serve_tick_at_8_slots_matches_plain(cuda):
    """The serving tick at 8 slots on the card (K1, K2, K4) against the
    same ticks on the CPU (the plain versions): six sessions of different
    seeds joined in two groups, ramp and full ticks, two slots left free
    and a masked Mimi step every tick; tokens and scalars exact, emitted
    waveform rows within 1e-4 of their peak."""
    from sopro_tpu_torch.models import sopro as M

    nar_ctx = SoproTTSConfig(**CFG).rf_nar()
    ref_tokens = np.random.default_rng(2).integers(0, 32, (10, 8)).astype(np.int32)
    outs = []
    for tts in _tts_pair(cuda):
        eng = tts.engine
        st = eng.serve_state(8, 16, CFG["max_frames"])
        ref = eng.prepare_reference(ref_tokens)

        def join(slots, seeds):
            g = len(slots)
            ids, mask = np.zeros((g, 16), np.int32), np.zeros((g, 16), bool)
            for i, s in enumerate(seeds):
                enc = tts.encode_text(f"row {s}")
                ids[i, : len(enc)], mask[i, : len(enc)] = enc, True
            settings = {"top_p": [0.9] * g, "temperature": [1.05] * g,
                        "recovery_top_p": [0.85] * g, "recovery_temp": [1.2] * g,
                        "min_gen": [3] * g, "max_frames": [CFG["max_frames"]] * g}
            eng.serve_join(st, slots, ids, mask, M.tile_reference(ref, g), [1.0] * g, seeds,
                           settings)

        kernels.reset_launches()
        join([0, 2, 3, 5], [1, 2, 3, 4])
        ticks = [eng.serve_tick(st, chunk=2, nar_ctx=nar_ctx, first_only=True),
                 eng.serve_tick(st, chunk=4, nar_ctx=nar_ctx)]
        join([1, 6], [5, 6])
        ticks.append(eng.serve_tick(st, chunk=2, nar_ctx=nar_ctx, first_only=True))
        ticks += [eng.serve_tick(st, chunk=4, nar_ctx=nar_ctx) for _ in range(5)]
        outs.append(([t.cpu() for t in ticks], st.carry.tokens.cpu(), st.emitted.cpu()))
    assert all(kernels.LAUNCHES[k] > 0 for k in ("ar_loop", "nar_heads", "seanet_chunk"))
    (cpu_ticks, cpu_tok, cpu_em), (gpu_ticks, gpu_tok, gpu_em) = outs
    assert torch.equal(cpu_tok, gpu_tok) and torch.equal(cpu_em, gpu_em)
    hop = MimiConfig(**SMALL_MIMI).hop_length
    for want, got in zip(cpu_ticks, gpu_ticks):
        n = want.numel() - 4 * 8
        assert torch.equal(want[n:], got[n:])
        n_new = want[n:].reshape(4, 8)[3]
        wav_w, wav_g = want[:n].reshape(8, -1), got[:n].reshape(8, -1)
        for r in range(8):
            k = int(n_new[r]) * hop
            if k:
                peak = float(wav_w[r, :k].abs().max())
                assert float((wav_w[r, :k] - wav_g[r, :k]).abs().max()) <= 1e-4 * peak


@pytest.mark.cuda
def test_seanet_chunk_kernel_at_8_rows_with_a_mask(cuda):
    """K4 through `mimi_decode_step` at B = 8 and chunk 16 (full Mimi
    width), as the serving tick runs it: rows at different stream ages (one
    row reset mid-way), random masks; the emitting rows' samples within
    1e-4 of their peak of the plain version on the CPU fed the same codes,
    the masked rows' state left as it was."""
    from sopro_tpu_torch.codec.streaming import (
        MimiStreamState, init_mimi_stream_state, mimi_decode_step, reset_stream_rows,
    )
    from sopro_tpu_torch.codec.vocoder import pack_seanet_decoder

    def to(state, dev):
        return MimiStreamState(*(tuple(x.to(dev) for x in leaf) if isinstance(leaf, tuple)
                                 else leaf.to(dev) for leaf in state))

    mcfg = MimiConfig()
    mtree = W.init_mimi_params(3, mcfg)
    W.fill_zero_inits(None, mtree, 4)
    codec = W.mimi_params_from_jax(mtree, mcfg, cuda)
    cpu = W.mimi_params_from_jax(mtree, mcfg, "cpu")
    packed_cpu = pack_seanet_decoder(cpu.p["decoder"], mcfg)
    rng = np.random.default_rng(5)
    st = init_mimi_stream_state(mcfg, 8, cuda)
    st_cpu = init_mimi_stream_state(mcfg, 8, "cpu")
    for step in range(4):
        codes = torch.from_numpy(rng.integers(0, mcfg.codebook_size, (8, 16, mcfg.num_quantizers)))
        mask = torch.from_numpy(rng.random(8) < 0.6)
        mask[0] = True
        if step == 2:
            rows = torch.zeros(8, dtype=torch.bool)
            rows[3] = True
            st, st_cpu = reset_stream_rows(st, rows.to(cuda)), reset_stream_rows(st_cpu, rows)
        before = kernels.LAUNCHES["seanet_chunk"]
        wav, new = mimi_decode_step(codec.p, mcfg, codes.to(cuda), st, mask=mask.to(cuda),
                                    packed=codec.packed_decoder())
        assert kernels.LAUNCHES["seanet_chunk"] == before + 1
        wav_p, new_cpu = mimi_decode_step(cpu.p, mcfg, codes, st_cpu, mask=mask, packed=packed_cpu)
        assert torch.equal(new.pos.cpu(), new_cpu.pos)
        for r in range(8):
            if bool(mask[r]):
                peak = float(wav_p[r].abs().max())
                assert float((wav[r].cpu() - wav_p[r]).abs().max()) <= 1e-4 * peak
            else:
                assert torch.equal(new.emb_hist[r], st.emb_hist[r])
        st, st_cpu = new, to(new, "cpu")


def _kernel_outputs(dev):
    """K1, K5, K2, K3 and K4 launched on tensors of `dev` (the small
    models, fixed inputs) -> their outputs on the CPU."""
    from sopro_tpu_torch.codec.mimi_config import required_halo
    from sopro_tpu_torch.codec.vocoder import seanet_decode, seanet_decode_chunk
    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.ops.ar_loop import ar_loop
    from sopro_tpu_torch.ops.ar_step import ar_step
    from sopro_tpu_torch.ops.nar_heads import nar_heads_argmax

    _, tts = _tts_pair(dev)
    model, cfg, codec = tts.engine.model, tts.cfg, tts.engine.codec
    g = torch.Generator().manual_seed(9)
    txt = torch.randn(2, 12, cfg.d_model, generator=g).to(dev)
    mask = torch.stack([torch.arange(12) < 9, torch.arange(12) < 5]).to(dev)
    cond = (torch.randn(2, 25, cfg.d_model, generator=g) * 0.1).to(dev)
    carry = M.init_ar_carry(cfg, 2, 25, 7, dev)
    state = {k: getattr(carry, k) for k in ("t", "last", "streak", "stopped", "first_eos", "key",
                                            "hist", "bufs")}
    out = dict(zip(("k1_tokens", "k1_state"),
                   ar_loop(M.ar_context(model, txt, mask), cond, state,
                           M.ARSettings().per_row(2, dev), 25, True)))
    out["k1_state"] = out["k1_state"]["bufs"]
    x = torch.randn(2, cfg.d_model, generator=g).to(dev)
    out["k5_logits"], out["k5_bufs"] = ar_step(M.ar_step_context(model, txt, mask), x, state["bufs"])
    hid, w, b, packed = next(iter(model.nar.head_stacks().values()))
    out["k2"] = nar_heads_argmax(torch.randn(1, 37, w.shape[1], generator=g).to(dev), hid, w, b,
                                 packed)
    mcfg = codec.cfg
    out["k3"] = seanet_decode(codec.packed_decoder(), mcfg,
                              torch.randn(2, 13, mcfg.hidden_size, generator=g).to(dev))
    ext = torch.randn(2, required_halo(mcfg) + 4, mcfg.hidden_size, generator=g).to(dev)
    out["k4"] = seanet_decode_chunk(codec.packed_decoder(), mcfg, ext,
                                    torch.tensor([0, 6], dtype=torch.int32, device=dev))
    return {k: v.cpu() for k, v in out.items()}


@pytest.mark.cuda
def test_launch_device_kernels_run_on_their_tensors_card(cuda):
    """With cuda:0 current, K1, K5, K2, K3 and K4 on tensors of the last
    card launch there (each entry point runs inside `kernels.on_device`)
    and equal the same launches on cuda:0: ids and tokens exact, floats
    within 1e-6 of their peak (one card model, one kernel). Skips with
    fewer than 2 cards."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs 2 or more CUDA devices")
    torch.cuda.set_device(0)
    want = _kernel_outputs(torch.device("cuda", 0))
    kernels.reset_launches()
    got = _kernel_outputs(torch.device("cuda", n - 1))
    assert torch.cuda.current_device() == 0
    assert all(kernels.LAUNCHES[k] > 0 for k in kernels.KERNELS), kernels.LAUNCHES
    for k, w in want.items():
        if w.is_floating_point():
            assert float((got[k] - w).abs().max()) <= 1e-6 * float(w.abs().max()), k
        else:
            assert torch.equal(got[k], w), k


MESH_CAPS = (20, 20, 20, 20, 4, 8, 12, 16, 20, 20, 20, 20)


@pytest.mark.cuda
def test_mesh_serve_and_batch_match_one_shard(cuda):
    """chip_smoke phase 14's bars at the small config: dp = 4 over 4 cards
    (2 over 2 or 3), else 2 shards on cuda:0. A `ContinuousBatcher(mesh=)`
    (8 slots, chunk 4, ramp 2, pcm16) takes an 8-way burst and 4 later
    sessions as the unsharded batcher does: each session's frame count
    equal, PCM within 1 LSB, AR tokens equal for the sessions still in
    their slot; K1 launches = the shards' ticks. `synthesize_batch(mesh=)`
    rows within 1e-4 of their peak of the unsharded batch's, lengths equal."""
    from sopro_tpu_torch.parallel import make_mesh
    from sopro_tpu_torch.serve import ContinuousBatcher

    n = torch.cuda.device_count()
    dp = 4 if n >= 4 else 2
    devices = [torch.device("cuda", i) for i in range(dp)] if n >= 2 else [torch.device("cuda", 0)] * 2
    mesh = make_mesh(dp, dp=dp, tp=1, devices=devices)
    _, tts = _tts_pair(cuda)
    ref = tts.prepare_reference(ref_tokens_tq=np.random.default_rng(2).integers(
        0, 32, (10, 8)).astype(np.int32))
    kw = dict(slots=8, chunk_frames=4, ramp_frames=2, text_bucket=16, max_frames=CFG["max_frames"],
              pcm16=True)
    runs = {}
    for name, extra in (("one", {}), ("mesh", {"mesh": mesh})):
        b = ContinuousBatcher(tts, **kw, **extra)
        kernels.reset_launches()
        try:
            hs = [b.submit(f"row {i}", ref, seed=100 + i, max_frames=MESH_CAPS[i]) for i in range(8)]
            first = hs[0].out.get(timeout=300)
            hs += [b.submit(f"row {i}", ref, seed=100 + i, max_frames=MESH_CAPS[i])
                   for i in range(8, 12)]
            outs = [np.concatenate(([first] if i == 0 else []) + list(h.chunks()), axis=1)
                    for i, h in enumerate(hs)]
        finally:
            b.stop()
        assert kernels.LAUNCHES["ar_loop"] == sum(b.stats()["shard_ticks"]) > 0
        last = {h.slot: i for i, h in enumerate(hs)}
        toks = {i: b.states[slot // b.per].carry.tokens[slot % b.per].cpu()
                for slot, i in last.items()}
        runs[name] = (outs, toks)
    (one, one_toks), (sharded, mesh_toks) = runs["one"], runs["mesh"]
    for a, m in zip(one, sharded):
        assert a.shape == m.shape
        assert int(np.abs(a.astype(np.int32) - m.astype(np.int32)).max(initial=0)) <= 1
    common = set(one_toks) & set(mesh_toks)
    assert common
    for i in common:
        frames = one[i].shape[1] // tts.engine.mimi_cfg.hop_length
        assert torch.equal(one_toks[i][:frames], mesh_toks[i][:frames]), i
    texts, seeds = ("hello there", "a second, longer request", "hello there", "short one"), (3, 5, 3, 4)
    want = tts.synthesize_batch(texts, ref=ref, max_frames=24, seeds=seeds)
    kernels.reset_launches()
    got = tts.synthesize_batch(texts, ref=ref, max_frames=24, seeds=seeds, mesh=mesh)
    assert all(kernels.LAUNCHES[k] > 0 for k in ("ar_loop", "nar_heads", "seanet")), kernels.LAUNCHES
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4 * float(np.abs(w).max()), rtol=0)


def _train_models(dev):
    """The same TRAIN_CFG model on the CPU and on `dev`."""
    cfg = SoproTTSConfig(**TRAIN_CFG)
    tree = W.init_sopro_params(11, cfg, TEXT_VOCAB)
    W.fill_zero_inits(tree, None, 12)
    return [W.sopro_params_from_jax(tree, cfg, d) for d in ("cpu", dev)]


@pytest.mark.cuda
def test_train_step_on_cuda_matches_cpu(cuda):
    """One training step on the card against the CPU, TF32 off: the loss
    within 1e-5 relative, each leaf's gradient within 1e-4 of its largest
    entry (plus 1e-9). The AdamW step then runs on both from the card's
    gradients (an element whose gradient is near 0 takes a step of about
    lr whatever its sign, so the rounding of the two backwards is kept out
    of it): the parameters within 1e-6."""
    from sopro_tpu_torch import train as T

    out = []
    for model, dev in zip(_train_models(cuda), ("cpu", cuda)):
        opt = T.make_optimizer(model, lr=1e-3)
        opt.zero_grad(set_to_none=False)
        loss, metrics = T.loss_fn(model, torch_batch(make_batch(), dev))
        loss.backward()
        out.append((model, opt, metrics))
    (m_cpu, o_cpu, met_cpu), (m_gpu, o_gpu, met_gpu) = out
    for k in met_cpu:
        np.testing.assert_allclose(float(met_gpu[k].detach()), float(met_cpu[k].detach()),
                                   rtol=1e-5, err_msg=k)
    p_gpu = dict(m_gpu.named_parameters())
    for name, p in m_cpu.named_parameters():
        g, want = p_gpu[name].grad.cpu(), p.grad
        assert float((g - want).abs().max()) <= 1e-4 * float(want.abs().max()) + 1e-9, name
        p.grad = g
    for opt in (o_cpu, o_gpu):
        T.fill_missing_grads(opt)
        opt.step()
    for name, p in m_cpu.named_parameters():
        assert float((p_gpu[name].detach().cpu() - p.detach()).abs().max()) <= 1e-6, name


@pytest.mark.cuda
def test_weights_changed_rebuilds_the_kernel_packs(cuda):
    """Serve (K1's weight stream and K2's packs are built), take one step,
    serve again: the tokens and waveform equal a model built afresh from the
    trained weights, launching K1 and K2 again."""
    from sopro_tpu_torch import train as T
    from sopro_tpu_torch.engine import Engine
    from sopro_tpu_torch.tokenizer import SimpleCharTokenizer
    from sopro_tpu_torch.tts import SoproTTS

    model = _train_models(cuda)[1]
    mcfg = MimiConfig(**SMALL_MIMI)
    mtree = W.init_mimi_params(13, mcfg)

    def tts_of(m):
        return SoproTTS(Engine(m, W.mimi_params_from_jax(mtree, mcfg, cuda)), m.cfg,
                        SimpleCharTokenizer())

    tts = tts_of(model)
    ref = np.random.default_rng(14).integers(0, 32, (12, 8)).astype(np.int32)
    kw = dict(ref_tokens_tq=ref, max_frames=20, seed=4, fused=True)
    tts.synthesize("before the step", **kw)
    assert model.ar._streams and model.nar._stacks is not None
    T.make_train_step(model, T.make_optimizer(model, lr=1e-2))(torch_batch(make_batch(), cuda))
    assert not model.ar._streams and model.nar._stacks is None
    kernels.reset_launches()
    got = tts.synthesize("after the step", **kw)
    assert kernels.LAUNCHES["ar_loop"] > 0 and kernels.LAUNCHES["nar_heads"] > 0, kernels.LAUNCHES
    fresh = W.sopro_params_from_jax(W.sopro_tree(model), model.cfg, cuda)
    np.testing.assert_array_equal(got, tts_of(fresh).synthesize("after the step", **kw))


@pytest.mark.cuda
def test_tp_train_step_on_cuda_matches_unsharded(cuda):
    """The (dp=1, tp=2) layout with both shards on cuda:0 against the
    unsharded step on the card, TF32 off: the metrics within 2e-5 relative,
    each leaf's gathered gradient within 1e-4 of its peak plus 1e-6 of the
    largest gradient, and after 2 steps at most 1e-4 of the parameters'
    elements beyond 1e-6 and none beyond 5e-5 (lr 1e-3: an element whose
    gradient is near 0 takes a step whose size its rounding sets). Every
    master and every gradient stays on the card."""
    from sopro_tpu_torch import train as T
    from sopro_tpu_torch.parallel import make_mesh
    from sopro_tpu_torch.parallel import tensor as TP

    dev = torch.device("cuda", 0)
    plain, model = _train_models(dev)[1], _train_models(dev)[1]
    mesh = make_mesh(2, dp=1, tp=2, devices=[dev] * 2)
    state, opt = TP.shard_train_state(mesh, model, T.make_optimizer(model, lr=1e-3))
    plain_opt = T.make_optimizer(plain, lr=1e-3)
    batch = torch_batch(make_batch(), dev)
    for o, f in ((opt, lambda: TP.loss_fn(state, batch)), (plain_opt, lambda: T.loss_fn(plain, batch))):
        o.zero_grad(set_to_none=False)
        loss, _ = f()
        loss.backward()
        T.fill_missing_grads(o)
    want = {n: p.grad for n, p in plain.named_parameters()}
    floor = 1e-6 * max(float(g.abs().max()) for g in want.values())
    for lay in state.layouts:
        parts = state.leaves[lay.path]
        assert all(p.is_cuda and p.grad.is_cuda for p in parts), lay.path
        got = lay.join([p.grad for p in parts])
        ref = want[lay.name]
        assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max()) + floor, lay.name

    model, plain = _train_models(dev)[1], _train_models(dev)[1]
    state, opt = TP.shard_train_state(mesh, model, T.make_optimizer(model, lr=1e-3))
    steps = TP.make_train_step(state, opt), T.make_train_step(plain, T.make_optimizer(plain, lr=1e-3))
    for _ in range(2):
        got, want = (s(batch) for s in steps)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-5, err_msg=k)
    full = state.full_leaves(dev)
    diff = torch.cat([(full[n] - p.detach()).abs().flatten() for n, p in plain.named_parameters()])
    assert float(diff.max()) <= 5e-5 and int((diff > 1e-6).sum()) <= 1e-4 * diff.numel()


# ---------------------------------------------------------------------------
# the bfloat16 instantiations (RuntimeConfig(compute_dtype="bfloat16"))
# ---------------------------------------------------------------------------
# Tolerances: each kernel rounds to bfloat16 at the points its plain version
# rounds, but sums in another order, so a value can land one bfloat16 step
# (2^-8 relative) away and carry that on: waveforms and logits within 1e-2
# of their peak, ids equal away from a 1e-4 top-2 margin, AR tokens equal up
# to the first step where the plain run's penalized top-2 margin is within
# 1e-2 of its peak logit (`chip_smoke.first_divergence`).

BF16_TOL = 1e-2


def _bf16(tree):
    from sopro_tpu_torch.models.base import tree_map

    return tree_map(lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t, tree)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,h,hd,v", [(37, 3, 64, 256), (401, 16, 256, 2048)])
def test_nar_heads_bf16_kernel_matches_plain(cuda, rows, h, hd, v):
    """K2's bfloat16 instantiation (bfloat16 `wgmma` products)
    against its plain version: ids equal wherever the float64 top-2 margin
    of the rounded z + hid exceeds 1e-4; an exact tie goes to the lowest
    index; the bfloat16 counter counts the launch."""
    from sopro_tpu_torch.ops.nar_heads import (
        nar_heads_argmax, nar_heads_argmax_plain, pack_nar_heads,
    )

    g = torch.Generator().manual_seed(rows)
    z, hid = torch.randn(1, rows, hd, generator=g), torch.randn(h, hd, generator=g) * 0.1
    w = torch.randn(h, hd, v, generator=g) * 0.05
    bias = torch.randn(h, v, generator=g) * 0.05
    w[0, :, v - 3] = w[0, :, 5]
    bias[0, 5] = bias[0, v - 3] = 30.0
    z, hid, w, bias = (x.to(cuda, torch.bfloat16) for x in (z, hid, w, bias))
    kernels.reset_launches()
    got = nar_heads_argmax(z, hid, w, bias, pack_nar_heads(w))
    assert kernels.LAUNCHES_BF16["nar_heads"] == 1 and kernels.LAUNCHES["nar_heads"] == 0
    want = nar_heads_argmax_plain(z, hid, w, bias)
    zh = (z[:, :, None] + hid[None, None]).double()
    logits = torch.einsum("bthd,hdv->bthv", zh, w.double()) + bias.double()[None, None]
    top2 = torch.topk(logits, 2, dim=-1).values
    assert not bool(((got != want) & (top2[..., 0] - top2[..., 1] > 1e-4)).any())
    assert bool((got[..., 0] == 5).all())


@pytest.mark.cuda
@pytest.mark.parametrize("width,t", [("small", 13), ("full", 100)])
def test_seanet_bf16_kernel_matches_plain(cuda, width, t):
    """K3's bfloat16 instantiation (the conv kernel, and at full width the
    fused residual blocks of the 128- and 64-channel stages) against the
    bfloat16 plain version: a bfloat16 waveform within 1e-2 of its peak."""
    from sopro_tpu_torch.codec.mimi import seanet_apply
    from sopro_tpu_torch.codec.mimi_config import decoder_plan
    from sopro_tpu_torch.codec.vocoder import pack_seanet_decoder, seanet_decode

    mcfg = MimiConfig(**SMALL_MIMI) if width == "small" else MimiConfig()
    mtree = W.init_mimi_params(3, mcfg)
    W.fill_zero_inits(None, mtree, 4)
    dec = _bf16(W.to_torch(mtree["decoder"], cuda))
    emb = torch.randn(2, t, mcfg.hidden_size, generator=torch.Generator().manual_seed(1))
    emb = emb.to(cuda, torch.bfloat16)
    kernels.reset_launches()
    got = seanet_decode(pack_seanet_decoder(dec, mcfg), mcfg, emb)
    assert kernels.LAUNCHES_BF16["seanet"] == 1 and kernels.LAUNCHES["seanet"] == 0
    want = seanet_apply(dec, decoder_plan(mcfg), emb)[..., 0]
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    peak = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= BF16_TOL * peak


@pytest.mark.cuda
@pytest.mark.parametrize("width,b,m25,hist", [("small", 2, 4, (0, 6)), ("full", 2, 12, (3, 40))])
def test_seanet_chunk_bf16_kernel_matches_plain(cuda, width, b, m25, hist):
    """K4's bfloat16 instantiation (valid mode over [halo ++ chunk], rows
    with partial histories) against its bfloat16 plain version: within 1e-2
    of peak, and a repeated call bit-identical."""
    from sopro_tpu_torch.codec.mimi_config import required_halo
    from sopro_tpu_torch.codec.vocoder import (
        pack_seanet_decoder, seanet_decode_chunk, seanet_decode_chunk_plain,
    )

    mcfg = MimiConfig(**SMALL_MIMI) if width == "small" else MimiConfig()
    mtree = W.init_mimi_params(3, mcfg)
    W.fill_zero_inits(None, mtree, 4)
    dec = _bf16(W.to_torch(mtree["decoder"], cuda))
    packed = pack_seanet_decoder(dec, mcfg)
    g = torch.Generator().manual_seed(b * 100 + m25)
    ext = torch.randn(b, required_halo(mcfg) + m25, mcfg.hidden_size, generator=g)
    ext = ext.to(cuda, torch.bfloat16)
    n_hist = torch.tensor(hist, dtype=torch.int32, device=cuda)
    got = seanet_decode_chunk(packed, mcfg, ext, n_hist)
    assert torch.equal(got, seanet_decode_chunk(packed, mcfg, ext, n_hist))
    want = seanet_decode_chunk_plain(dec, mcfg, ext, n_hist)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    peak = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= BF16_TOL * peak


def _dtype(name):
    return getattr(torch, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [6, 63, 65, 401, 1604])
def test_nar_heads_wgmma_kernel_ragged_rows(cuda, rows, dtype):
    """K2's `wgmma` kernel at row counts around its 64-row tile (6: one
    zero-padded tile; 63 and 65: a row short of and past one) and at the
    main paths' 401 and 1,604 (128-row tiles), H = 4, hd 256, V 2,011 (the
    last cluster block ragged): ids equal the plain version's wherever the
    float64 top-2 margin exceeds 1e-5 (bfloat16: 1e-4), an exact tie goes to
    the lowest index, and the dtype's counter counts the launch."""
    from sopro_tpu_torch.ops.nar_heads import (
        nar_heads_argmax, nar_heads_argmax_plain, pack_nar_heads,
    )

    h, v, dt = 4, 2011, _dtype(dtype)
    g = torch.Generator().manual_seed(rows)
    z, hid = torch.randn(2, rows, 256, generator=g), torch.randn(h, 256, generator=g) * 0.1
    w = torch.randn(h, 256, v, generator=g) * 0.02
    bias = torch.randn(h, v, generator=g) * 0.02
    w[1, :, 2000] = w[1, :, 700]
    bias[1, 700] = bias[1, 2000] = 30.0
    z, hid, w, bias = (x.to(cuda, dt) for x in (z, hid, w, bias))
    kernels.reset_launches()
    got = nar_heads_argmax(z, hid, w, bias, pack_nar_heads(w))
    assert kernels.LAUNCHES_BY_DTYPE[dtype]["nar_heads"] == 1
    want = nar_heads_argmax_plain(z, hid, w, bias)
    zh = (z[:, :, None] + hid[None, None]).to(dt).double()
    logits = torch.einsum("bthd,hdv->bthv", zh, w.double()) + bias.double()[None, None]
    top2 = torch.topk(logits, 2, dim=-1).values
    margin = 1e-5 if dtype == "float32" else 1e-4
    assert got.shape == (2, rows, h)
    assert not bool(((got != want) & (top2[..., 0] - top2[..., 1] > margin)).any())
    assert bool((got[..., 1] == 700).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 4])
def test_seanet_wgmma_kernel_ragged_time(cuda, b, dtype):
    """K3 at full Mimi width over 37 25 Hz rows: every conv's rows (37, 296,
    1,776, 8,880, 35,520) end in a partial 128-row tile of the `wgmma`
    kernel, and at B = 4 the tiles of one batch row never read another's.
    Within 1e-4 of peak of the plain version in float32, within one bfloat16
    step (1e-2) of the bfloat16 plain version's peak."""
    from sopro_tpu_torch.codec.mimi import seanet_apply
    from sopro_tpu_torch.codec.mimi_config import decoder_plan
    from sopro_tpu_torch.codec.vocoder import pack_seanet_decoder, seanet_decode

    dt, mcfg = _dtype(dtype), MimiConfig()
    mtree = W.init_mimi_params(3, mcfg)
    W.fill_zero_inits(None, mtree, 4)
    dec = W.to_torch(mtree["decoder"], cuda)
    dec = dec if dtype == "float32" else _bf16(dec)
    emb = torch.randn(b, 37, mcfg.hidden_size, generator=torch.Generator().manual_seed(b)).to(cuda, dt)
    got = seanet_decode(pack_seanet_decoder(dec, mcfg), mcfg, emb)
    want = seanet_apply(dec, decoder_plan(mcfg), emb)[..., 0]
    assert got.dtype == dt and got.shape == want.shape == (b, 37 * 960)
    peak = float(want.float().abs().max())
    tol = 1e-4 if dtype == "float32" else BF16_TOL
    assert float((got.float() - want.float()).abs().max()) <= tol * peak


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,m25,hist", [(2, 12, (2, 7)), (2, 32, (0, 8)),
                                        (8, 32, (0, 2, 4, 6, 8, 8, 8, 8))])
def test_seanet_chunk_full_width_partial_histories(cuda, b, m25, hist, dtype):
    """K4 at full Mimi width, chunks of 6 and 16 AR frames, rows with
    partial histories: its short convs on the split-K path, its convs of
    128 rows or more on the `wgmma` kernel with the stream-start mask per
    batch row. Against the plain version (1e-4 of peak in float32, 1e-2 in
    bfloat16), a repeated call bit-identical."""
    from sopro_tpu_torch.codec.mimi_config import required_halo
    from sopro_tpu_torch.codec.vocoder import (
        pack_seanet_decoder, seanet_decode_chunk, seanet_decode_chunk_plain,
    )

    dt, mcfg = _dtype(dtype), MimiConfig()
    mtree = W.init_mimi_params(3, mcfg)
    W.fill_zero_inits(None, mtree, 4)
    dec = W.to_torch(mtree["decoder"], cuda)
    dec = dec if dtype == "float32" else _bf16(dec)
    packed = pack_seanet_decoder(dec, mcfg)
    g = torch.Generator().manual_seed(b * 100 + m25)
    ext = torch.randn(b, required_halo(mcfg) + m25, mcfg.hidden_size, generator=g).to(cuda, dt)
    n_hist = torch.tensor(hist, dtype=torch.int32, device=cuda)
    got = seanet_decode_chunk(packed, mcfg, ext, n_hist)
    assert torch.equal(got, seanet_decode_chunk(packed, mcfg, ext, n_hist))
    want = seanet_decode_chunk_plain(dec, mcfg, ext, n_hist)
    assert got.dtype == dt and got.shape == want.shape == (b, m25 * 960)
    peak = float(want.float().abs().max())
    tol = 1e-4 if dtype == "float32" else BF16_TOL
    assert float((got.float() - want.float()).abs().max()) <= tol * peak


def _bf16_tts(dev):
    from sopro_tpu_torch.config import RuntimeConfig

    return _tts_pair(dev, RuntimeConfig(compute_dtype="bfloat16"))[1]


@pytest.mark.cuda
def test_ar_loop_bf16_kernel_matches_plain(cuda):
    """K1's bfloat16 instantiation against the plain loop (the generator's
    step, rounding where K1 rounds) over 25 near-greedy steps: tokens equal
    up to the first near-tie; with no divergence the bfloat16 ring buffers
    within 1e-2 of their peak."""
    from chip_smoke import RecordingContext, first_divergence
    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.ops.ar_loop import ar_loop, ar_loop_plain

    tts = _bf16_tts(cuda)
    model, cfg = tts.engine.model, tts.cfg
    g = torch.Generator().manual_seed(2)
    txt = torch.randn(1, 12, cfg.d_model, generator=g).to(cuda, torch.bfloat16)
    mask = (torch.arange(12) < 9)[None].to(cuda)
    cond = (torch.randn(1, 25, cfg.d_model, generator=g) * 0.1).to(cuda, torch.bfloat16)
    ctx = M.ar_context(model, txt, mask)

    def fresh():
        c = M.init_ar_carry(cfg, 1, 25, 7, cuda, torch.bfloat16)
        return {k: getattr(c, k) for k in ("t", "last", "streak", "stopped",
                                           "first_eos", "key", "hist", "bufs")}

    per_row = M.ARSettings(temperature=1e-4, anti_loop=False).per_row(1, cuda)
    kernels.reset_launches()
    got, gs = ar_loop(ctx, cond, fresh(), per_row, 25, False)
    assert kernels.LAUNCHES_BF16["ar_loop"] == 1 and kernels.LAUNCHES["ar_loop"] == 0
    assert gs["bufs"].dtype == torch.bfloat16
    rec = RecordingContext(ctx)
    want, ws = ar_loop_plain(rec, cond, fresh(), per_row, 25, False)
    first_divergence(got, want, rec.logits, 0, "K1 bf16 against its plain version")
    if torch.equal(got, want):
        peak = float(ws["bufs"].float().abs().max())
        assert float((gs["bufs"].float() - ws["bufs"].float()).abs().max()) <= BF16_TOL * peak


@pytest.mark.cuda
def test_ar_step_bf16_kernel_matches_plain(cuda):
    """K5's bfloat16 instantiation against its plain version at B = 2 (one
    row partly masked) over 5 chained steps: float32 logits and bfloat16
    ring buffers within 1e-2 of their peak."""
    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.ops.ar_step import ar_step, ar_step_plain

    tts = _bf16_tts(cuda)
    model, cfg = tts.engine.model, tts.cfg
    g = torch.Generator().manual_seed(5)
    txt = torch.randn(2, 12, cfg.d_model, generator=g).to(cuda, torch.bfloat16)
    mask = (torch.arange(12)[None, :] < torch.tensor([12, 5])[:, None]).to(cuda)
    ctx = M.ar_step_context(model, txt, mask)
    bufs = torch.randn(cfg.n_layers_ar, 2, 9, cfg.d_model, generator=g).to(cuda, torch.bfloat16)
    kernels.reset_launches()
    for _ in range(5):
        x = torch.randn(2, cfg.d_model, generator=g).to(cuda, torch.bfloat16)
        (lg, bg), (lw, bw) = ar_step(ctx, x, bufs), ar_step_plain(ctx, x, bufs)
        assert lg.dtype == torch.float32 and bg.dtype == torch.bfloat16
        assert float((lg - lw).abs().max()) <= BF16_TOL * float(lw.abs().max())
        assert float((bg.float() - bw.float()).abs().max()) <= BF16_TOL * float(bw.float().abs().max())
        bufs = bw
    assert kernels.LAUNCHES_BF16["ar_step"] == 5 and kernels.LAUNCHES["ar_step"] == 0


@pytest.mark.cuda
def test_bf16_tensors_do_not_reach_a_float32_pack(cuda):
    """A bfloat16 tensor given with float32 weights (a float32 pack or
    context) raises, as does float16: no upcast, no fallback."""
    from sopro_tpu_torch.codec.vocoder import pack_seanet_decoder, seanet_decode
    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.ops.ar_loop import ar_loop
    from sopro_tpu_torch.ops.nar_heads import nar_heads_argmax

    z, hid = torch.randn(1, 6, 32, device=cuda), torch.randn(2, 32, device=cuda)
    w, b = torch.randn(2, 32, 64, device=cuda), torch.randn(2, 64, device=cuda)
    for zz in (z.to(torch.bfloat16), z.half()):
        with pytest.raises(ValueError):
            nar_heads_argmax(zz, hid, w, b)
    mcfg = MimiConfig(**SMALL_MIMI)
    packed = pack_seanet_decoder(W.to_torch(W.init_mimi_params(3, mcfg)["decoder"], cuda), mcfg)
    with pytest.raises(ValueError):
        seanet_decode(packed, mcfg, torch.randn(1, 5, mcfg.hidden_size, device=cuda).to(torch.bfloat16))
    _, tts = _tts_pair(cuda)
    model, cfg = tts.engine.model, tts.cfg
    txt, mask = torch.randn(1, 12, cfg.d_model, device=cuda), torch.ones(1, 12, dtype=torch.bool, device=cuda)
    ctx = M.ar_context(model, txt, mask)
    c = M.init_ar_carry(cfg, 1, 8, 7, cuda, torch.bfloat16)
    state = {k: getattr(c, k) for k in ("t", "last", "streak", "stopped", "first_eos", "key",
                                        "hist", "bufs")}
    with pytest.raises(ValueError):
        ar_loop(ctx, torch.randn(1, 8, cfg.d_model, device=cuda).to(torch.bfloat16), state,
                M.ARSettings().per_row(1, cuda), 8, True)


@pytest.mark.cuda
def test_bf16_slice_on_cuda_launches_the_bf16_kernels(cuda):
    """Under RuntimeConfig(compute_dtype="bfloat16") synthesize launches
    K1, K2 and K3 in bfloat16 and no float32 kernel, stream launches K4 in
    bfloat16, and the outputs are finite float32 of whole frames."""
    tts = _bf16_tts(cuda)
    ref = np.random.default_rng(12).integers(0, 32, (40, 8)).astype(np.int32)
    kernels.reset_launches()
    wav = tts.synthesize("hello there", ref_tokens_tq=ref, max_frames=24, seed=3, fused=True)
    assert all(kernels.LAUNCHES_BF16[k] > 0 for k in ("ar_loop", "nar_heads", "seanet"))
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES
    assert wav.dtype == np.float32 and np.isfinite(wav).all() and wav.shape[1] % 12 == 0
    kernels.reset_launches()
    chunks = list(tts.stream("hello there", ref_tokens_tq=ref, max_frames=24, seed=3,
                             chunk_frames=4))
    assert kernels.LAUNCHES_BF16["seanet_chunk"] > 0 and not any(kernels.LAUNCHES.values())
    assert all(c.dtype == np.float32 and np.isfinite(c).all() for c in chunks)
