"""The kernel tools' one builder, one swap and one roofline, on the CPU.

`kernels.build_variant` refuses an edit whose text is missing before it
looks for nvcc, and names its build by content (the tree's own source, from
any directory, is the tree's library); `kernels.using` puts the tree's
library back after an exception and refuses a build without the tree's
entry points. The bound and share that `bench_kernels` reports for K2 at
401 rows, K3 at B = 1 and K4 on a chunk are `cudabench.flops`' counts, the
ones the cells' `k2_roofline_pct.synth` and `k3_roofline_pct.synth` read:
the tool runs here at the test configs, its timer stubbed, K3's and K4's
launches emulated (`tests/test_torch_seanet_chunk.py`). `kernels.need`,
the CSM wrappers' tensor check, names the kernel and the argument it
refuses.
"""

import dataclasses
import re
import shutil
import types

import numpy as np
import pytest
import torch

from cudabench import flops
from sopro_tpu_torch import bench_kernels as BK
from sopro_tpu_torch import kernels
from sopro_tpu_torch import weights as W
from sopro_tpu_torch.codec import vocoder as V
from sopro_tpu_torch.codec.mimi_config import MimiConfig
from sopro_tpu_torch.config import SoproTTSConfig

from tests.test_torch_cuda import CFG, SMALL_MIMI, TEXT_VOCAB


@pytest.fixture
def no_nvcc(monkeypatch, tmp_path):
    """nvcc unreachable, and builds written under tmp_path."""
    calls = []
    monkeypatch.setattr(kernels, "_nvcc", lambda: calls.append(1) or "/no/such/nvcc")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "kernels")
    return calls


@pytest.mark.parametrize("source", kernels.SOURCES)
def test_build_variant_refuses_a_missing_edit_before_nvcc(no_nvcc, source):
    text = "this text is in no kernel source"
    with pytest.raises(ValueError, match=text):
        kernels.build_variant(source, edits=[("extern \"C\"", "extern \"C\""), (text, "x")])
    assert not no_nvcc
    assert not (kernels.BUILD_DIR).exists()


def test_variants_are_named_by_content(tmp_path):
    tree = kernels._lib_path("ar_loop")
    copy = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, copy)
    assert kernels._plan("ar_loop", src_dir=copy)[0] == tree
    assert kernels._plan("ar_loop", defines=["-DSOPRO_AR_CLOCKS"])[0] != tree
    assert kernels._plan("ar_loop", edits=[("extern \"C\"", "extern \"C\" ")])[0] != tree
    (copy / "hopper.cuh").write_text((copy / "hopper.cuh").read_text() + "\n// edited\n")
    assert kernels._plan("ar_loop", src_dir=copy)[0] != tree


def _fake(names):
    return types.SimpleNamespace(**{n: object() for n in names})


def test_using_restores_the_tree_library_after_an_exception(monkeypatch):
    names = ("sopro_nar_heads_argmax", "sopro_nar_heads_argmax_bf16")
    tree, variant = _fake(names), _fake(names)
    monkeypatch.setitem(kernels._LIBS, "nar_heads", tree)
    assert kernels.entry_points("nar_heads") == list(names)
    with pytest.raises(KeyError, match="inside"):
        with kernels.using("nar_heads", variant) as got:
            assert got is variant and kernels.lib("nar_heads") is variant
            raise KeyError("inside")
    assert kernels.lib("nar_heads") is tree
    with pytest.raises(RuntimeError, match="sopro_nar_heads_argmax_bf16"):
        with kernels.using("nar_heads", _fake(names[:1])):
            pass
    assert kernels.lib("nar_heads") is tree


@pytest.fixture
def one_ms(monkeypatch):
    """The tools' timer stubbed: each call runs `fn` once and reads 1 ms."""
    monkeypatch.setattr(BK, "cuda_ms", lambda fn, reps=20: (fn(), 1.0)[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_bound_is_the_cells(monkeypatch, one_ms, dtype):
    cfg = SoproTTSConfig(**CFG)
    tree = W.init_sopro_params(3, cfg, TEXT_VOCAB)
    W.fill_zero_inits(tree, None, 4)
    model = W.sopro_params_from_jax(tree, cfg, "cpu")
    monkeypatch.setattr(BK, "NAR_ROWS", (401,))
    (row,) = BK.bench_nar(model, "cpu", np.random.default_rng(0), None, dtype)
    want = 1e3 * flops.k2_bound_s(cfg.to_dict(), 401, BK.dtype_name(dtype))
    assert row["rows"] == 401 and len(row["stages"]) == len(cfg.stage_order())
    assert row["bound_ms"] == pytest.approx(want, rel=1e-12)
    assert row["ms"] == len(row["stages"])
    assert row["share_pct"] == pytest.approx(100.0 * want / row["ms"], rel=1e-12)
    assert all(s["ids_differ"] == 0 for s in row["stages"])


@pytest.fixture
def small_mimi(monkeypatch, one_ms):
    """The test Mimi on the CPU, K3's and K4's launches emulated."""
    from tests.test_torch_seanet_chunk import _emulated_conv, _emulated_resblock

    monkeypatch.setattr(V, "_conv_cuda", _emulated_conv(V.MAX_SPLITS))
    monkeypatch.setattr(V, "_resblock_cuda", _emulated_resblock)
    mcfg = MimiConfig(**SMALL_MIMI)
    mtree = W.init_mimi_params(5, mcfg)
    W.fill_zero_inits(None, mtree, 6)
    return W.mimi_params_from_jax(mtree, mcfg, "cpu")


def test_k3_bound_is_the_cells(small_mimi):
    out = BK.bench_seanet(small_mimi, "cpu", np.random.default_rng(1), 1, None, torch.float32)
    want = 1e3 * flops.k3_bound_s(dataclasses.asdict(small_mimi.cfg), 401, "float32")
    assert out["bound_ms"] == pytest.approx(want, rel=1e-12)
    assert out["share_pct"] == pytest.approx(100.0 * want / out["ms"], rel=1e-12)
    assert len(out["launches"]) == len(small_mimi.packed_decoder()["k3"])
    assert len(out["convs"]) == len(small_mimi.packed_decoder()["ops"])
    assert out["err"]["vs_plain"] == 0.0  # on the CPU seanet_decode is the plain version


def test_k4_bound_is_the_cells_over_the_chunk(small_mimi):
    out = BK.bench_seanet_chunk(small_mimi, "cpu", np.random.default_rng(2), None, 2, 12, torch.float32)
    want = 1e3 * flops.k3_bound_s(dataclasses.asdict(small_mimi.cfg), 12, "float32")  # 2 x 6 frames
    assert out["bound_ms"] == pytest.approx(want, rel=1e-12)
    assert out["share_pct"] == pytest.approx(100.0 * want / out["ms"], rel=1e-12)
    assert out["err"] < 1e-5 and len(out["launches"]) == len(small_mimi.packed_decoder()["k3"])


def test_need_names_the_kernel_and_the_argument():
    """`kernels.need`, the wrappers' one tensor check: each refusal names
    the kernel and the argument; a tensor of the dtype, device, shape and
    alignment asked for passes."""
    x = torch.zeros(8, 4)
    kernels.need("k", "x", x, (8, 4), torch.float32, x.device)
    refused = [(None, (8, 4), torch.float32, 16, "is missing"),
               (x, (8, 4), torch.int64, 16, "must be torch.int64"),
               (x, (4, 8), torch.float32, 16, "must be contiguous (4, 8)"),
               (x.t(), (4, 8), torch.float32, 16, "must be contiguous (4, 8)"),
               (x.flatten()[1:], (31,), torch.float32, 16, "16-byte boundary")]
    for t, shape, dtype, align, why in refused:
        with pytest.raises(ValueError, match=r"^k: x .*" + re.escape(why)):
            kernels.need("k", "x", t, shape, dtype, x.device, align)
