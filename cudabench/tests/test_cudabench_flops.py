"""The operation and byte counts against hand counts at two shapes."""

import pytest

from cudabench import flops
from cudabench.tests.small import MIMI, SOPRO

FULL = dict(num_codebooks=32, codebook_size=2048, d_model=384, n_layers_text=2, n_layers_ar=6,
            ar_kernel=13, ar_text_attn_freq=2, n_layers_nar=6, nar_head_dim=256,
            nar_kernel_size=11, stage_B=[2, 4], stage_C=[5, 8], stage_D=[9, 16],
            stage_E=[17, 32], sv_student_dim=192, ref_enc_layers=2, ref_xattn_layers=3)
FULL_MIMI = dict(hidden_size=512, num_filters=64, num_residual_layers=1,
                 upsampling_ratios=[8, 6, 5, 4], kernel_size=7, last_kernel_size=3,
                 residual_kernel_size=3, compress=2, audio_channels=1, codebook_dim=256,
                 upsample_groups=512, num_hidden_layers=8, intermediate_size=2048,
                 num_attention_heads=8, head_dim=64, sliding_window=250)


def test_ar_step_by_hand():
    d = 384
    block = 2 * d * 2 * d + 2 * d * 4 * d + 2 * 4 * d * d + 2 * 13 * d  # glu, ff1, ff2, dwconv
    xattn = 2 * 2 * d * d + 2 * 2 * 100 * d  # q and out; scores and values over 100 keys
    head = 2 * d * 2049
    assert flops.ar_step(FULL, 100) == 6 * block + 3 * xattn + head
    d = 64
    block = 20 * d * d + 2 * 5 * d
    assert flops.ar_step(SOPRO, 7) == 2 * block + 1 * (4 * d * d + 4 * 7 * d) + 2 * d * 33


def test_nar_by_hand():
    assert flops.nar_heads(FULL, 401) == 2 * 401 * 31 * 256 * 2048
    assert flops.nar_heads(SOPRO, 10) == 2 * 10 * 7 * 32 * 32
    d = 384
    per_stage = 6 * (20 * d * d + 2 * 11 * d) + 2 * d * 256
    assert flops.nar_trunk(FULL, 10) == 10 * 4 * per_stage


def test_seanet_by_hand():
    # full Mimi decoder over 2 frames at 25 Hz: convs and transpose convs layer by layer
    t = 2
    total = 2 * t * 7 * 512 * 1024
    for r, cin in zip((8, 6, 5, 4), (1024, 512, 256, 128)):
        t *= r
        total += 2 * t * 2 * cin * (cin // 2)  # k = 2r taps, r of them reach each output
        c = cin // 2
        total += 2 * t * 3 * c * (c // 2) + 2 * t * 1 * (c // 2) * c
    total += 2 * t * 3 * 64 * 1
    assert flops.seanet_decoder(FULL_MIMI, 2) == pytest.approx(total, rel=0, abs=0)
    small = dict(MIMI, num_residual_layers=1, kernel_size=7, last_kernel_size=3,
                 residual_kernel_size=3, compress=2, audio_channels=1)
    t, total = 4, 2 * 4 * 7 * 32 * 16
    for r, cin in zip((4, 3), (16, 8)):
        t *= r
        total += 2 * t * 2 * cin * (cin // 2)
        c = cin // 2
        total += 2 * t * 3 * c * (c // 2) + 2 * t * (c // 2) * c
    total += 2 * t * 3 * 4
    assert flops.seanet_decoder(small, 4) == total


def test_mimi_front_by_hand():
    h, t = 512, 8  # 4 frames -> 8 tokens, all within the window
    keys = sum(range(1, t + 1))
    per_layer = t * (8 * h * h + 4 * h * 2048) + 4 * keys * h
    expect = 2 * 2 * 4 * 256 * h + 2 * t * 2 * 1 * h + 8 * per_layer
    assert flops.mimi_front(FULL_MIMI, 4) == expect


def test_bounds_pick_the_larger_side():
    # K2 at 401 rows in float32: operations over 495 TF/s beat weight bytes over 3.35 TB/s
    ops = 2 * 401 * 31 * 256 * 2048 / 495e12
    assert flops.k2_bound_s(FULL, 401, "float32") == pytest.approx(ops)
    # at 1 row the weights' bytes bound it
    byts = 4 * (31 * 256 * 2048 + 31 * 2048 + 4 * 256 + 31 * 256) + 4 * 31
    assert flops.k2_bound_s(FULL, 1, "float32") == pytest.approx(byts / 3.35e12)
    assert flops.k2_bound_s(FULL, 401, "bfloat16") == pytest.approx(ops * 495 / 989)
