"""The three CUDA kernels against their plain PyTorch versions on the card,
at small shapes; each test skips without a CUDA device.

This file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

It also holds the small configurations the other test_torch_* files share.
Tolerances on the card: ids and tokens exact (argmax and sampler decisions
away from near-ties), waveforms within 1e-4 of their peak (fp32, summation
order differs from cuBLAS/cuDNN).
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


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sopro_tpu_torch.engine import configure_cuda_numerics

    configure_cuda_numerics()
    return torch.device("cuda")


def _tts_pair(dev):
    """The same random small model on the CPU and on `dev`."""
    from sopro_tpu_torch.engine import Engine
    from sopro_tpu_torch.tokenizer import SimpleCharTokenizer
    from sopro_tpu_torch.tts import SoproTTS

    cfg, mcfg = SoproTTSConfig(**CFG), MimiConfig(**SMALL_MIMI)
    tree, mtree = W.init_sopro_params(5, cfg, TEXT_VOCAB), W.init_mimi_params(5, mcfg)
    W.fill_zero_inits(tree, mtree, 6)
    return [
        SoproTTS(Engine(W.sopro_params_from_jax(tree, cfg, d),
                        W.mimi_params_from_jax(mtree, mcfg, d)), cfg, SimpleCharTokenizer())
        for d in ("cpu", dev)
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,hd,v", [(2, 37, 3, 64, 256), (1, 401, 16, 256, 2048), (1, 9, 2, 8, 130)])
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
def test_ar_loop_kernel_rows_match_solo(cuda):
    """B rows in one launch (one cluster each) give what each row gives
    alone, at production settings, with rows stopping at different steps."""
    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.ops.ar_loop import ar_loop

    _, tts = _tts_pair(cuda)
    model, cfg = tts.engine.model, tts.cfg
    g = torch.Generator().manual_seed(3)
    txt = torch.randn(2, 12, cfg.d_model, generator=g).to(cuda)
    mask = torch.stack([torch.arange(12) < 9, torch.arange(12) < 5]).to(cuda)
    cond = (torch.randn(2, 25, cfg.d_model, generator=g) * 0.1).to(cuda)
    keys = ("t", "last", "streak", "stopped", "first_eos", "key", "hist", "bufs")
    sett = M.ARSettings(min_gen_frames=4)
    both = {k: getattr(M.init_ar_carry(cfg, 2, 25, 11, cuda), k) for k in keys}
    tok2, st2 = ar_loop(M.ar_context(model, txt, mask), cond, both, sett.per_row(2, cuda), 25, True)
    for i in range(2):
        one = {k: (v[:, i:i + 1] if k == "bufs" else v[i:i + 1]).contiguous() for k, v in both.items()}
        ctx = M.ar_context(model, txt[i:i + 1], mask[i:i + 1])
        tok1, st1 = ar_loop(ctx, cond[i:i + 1], one, sett.per_row(1, cuda), 25, True)
        assert torch.equal(tok1[0], tok2[i])
        assert torch.equal(st1["t"][0], st2["t"][i]) and torch.equal(st1["hist"][0], st2["hist"][i])


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
    assert all(n > 0 for n in kernels.LAUNCHES.values()), kernels.LAUNCHES
    want = cpu.generate_tokens(text, cpu.prepare_reference(ref_tokens_tq=ref), **kw)
    np.testing.assert_array_equal(got, want)
    wg = gpu.synthesize(text, ref_tokens_tq=ref, **kw)
    wc = cpu.synthesize(text, ref_tokens_tq=ref, **kw)
    np.testing.assert_allclose(wg, wc, atol=1e-4 * float(np.abs(wc).max()), rtol=0)
