"""Checkpoints, the BPE tokenizer and the package surface of the torch port
against the JAX package on the CPU.

The snapshots are written here, offline: the Sopro weights by the JAX
package's `save_sopro_checkpoint` from random JAX parameters (zero-inits
filled), the Mimi snapshot as a random `transformers.MimiModel` state dict
plus config.json, the tokenizer a `tokenizers` WordLevel one. Both packages
load them. Bars: parameters and token ids exact, `synthesize` tokens exact
and waveforms within 1e-4 of their peak (fp32 stacks summed in another
order), safetensors bytes interchangeable with the `safetensors` package.
"""

import json
import os
import subprocess
import sys
import wave

import jax
import numpy as np
import pytest
import torch

from sopro_tpu import hub as JH
from sopro_tpu.codec.adapter import MimiCodec as JMimiCodec, MimiStreamDecoder as JStreamDecoder
from sopro_tpu.config import RuntimeConfig as JRuntime
from sopro_tpu.tokenizer import TextTokenizer as JTextTokenizer
from sopro_tpu.tts import SoproTTS as JTTS

from sopro_tpu_torch import hub as H
from sopro_tpu_torch import weights as W
from sopro_tpu_torch.codec.adapter import MimiCodec, MimiStreamDecoder
from sopro_tpu_torch.config import RuntimeConfig, SoproTTSConfig
from sopro_tpu_torch.engine import Engine
from sopro_tpu_torch.tokenizer import TextTokenizer
from sopro_tpu_torch.tts import SoproTTS

from tests.test_from_pretrained import _write_tokenizer
from tests.test_torch_cuda import CFG, SMALL_MIMI
from tests.test_torch_ops import make_trees

torch.set_num_threads(1)

TOL = 1e-4
RT = dict(text_buckets=(16, 32), ref_buckets=(16,), nar_pad_multiple=8)
REF = np.random.default_rng(7).integers(0, CFG["codebook_size"], (10, CFG["num_codebooks"])
                                        ).astype(np.int32)


def peak_close(got, want, tol=TOL):
    want = np.asarray(want)
    assert np.asarray(got).shape == want.shape
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * float(np.abs(want).max()))


def leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """(sopro dir, mimi dir, the Sopro tree written)."""
    from transformers.models.mimi.configuration_mimi import MimiConfig as HFMimi
    from transformers.models.mimi.modeling_mimi import MimiModel

    sopro_dir = str(tmp_path_factory.mktemp("sopro_repo"))
    mimi_dir = str(tmp_path_factory.mktemp("mimi_repo"))
    tree, _, jcfg, _, _, _ = make_trees(seed=21)
    JH.save_sopro_checkpoint(os.path.join(sopro_dir, "model.safetensors"), tree, jcfg)
    _write_tokenizer(sopro_dir)

    small = {k: v for k, v in SMALL_MIMI.items() if k != "frame_rate"}
    hf_cfg = HFMimi(**{**small, "upsampling_ratios": list(small["upsampling_ratios"])})
    torch.manual_seed(32)
    mm = MimiModel(hf_cfg).eval()
    JH.write_safetensors(os.path.join(mimi_dir, "model.safetensors"),
                         {k: v.detach().numpy() for k, v in mm.state_dict().items()})
    with open(os.path.join(mimi_dir, "config.json"), "w") as f:
        json.dump({**small, "frame_rate": float(hf_cfg.frame_rate),
                   "upsampling_ratios": list(small["upsampling_ratios"])}, f)
    return sopro_dir, mimi_dir, tree


@pytest.fixture(scope="module")
def pair(snapshot):
    """(JAX SoproTTS, port SoproTTS) from the same snapshot."""
    sopro_dir, mimi_dir, _ = snapshot
    jtts = JTTS.from_pretrained(sopro_dir, mimi_repo_id=mimi_dir, runtime=JRuntime(**RT))
    port = SoproTTS.from_pretrained(sopro_dir, mimi_repo_id=mimi_dir, runtime=RuntimeConfig(**RT),
                                    device="cpu", on_unconsumed="raise")
    return jtts, port


def test_safetensors_bytes_interchange(tmp_path):
    """The port's writer and reader against the safetensors package, both
    ways, with mixed dtypes and metadata."""
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(0)
    flat = {
        "a.weight": rng.standard_normal((3, 5)).astype(np.float32),
        "b": rng.integers(-9, 9, (4,)).astype(np.int64),
        "c.half": rng.standard_normal((2, 2)).astype(np.float16),
        "d.flag": np.array([True, False, True]),
        "e.scalar": np.array(1.5, np.float32),
        "f.i32": rng.integers(0, 100, (2, 3)).astype(np.int32),
    }
    meta = {"cfg": json.dumps({"d_model": 64})}
    ours = str(tmp_path / "ours.safetensors")
    H.write_safetensors(ours, flat, metadata=meta)
    theirs = load_file(ours)
    assert set(theirs) == set(flat)
    for k, v in flat.items():
        assert theirs[k].dtype == v.dtype
        np.testing.assert_array_equal(theirs[k], v)
    assert H.read_safetensors_metadata(ours) == meta

    other = str(tmp_path / "theirs.safetensors")
    save_file(flat, other, metadata=meta)
    back = H.load_flat_safetensors(other)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and back[k].flags.writeable
        np.testing.assert_array_equal(back[k], v)
    assert H.read_safetensors_metadata(other) == meta


def test_both_packages_load_equal_params(snapshot):
    sopro_dir, mimi_dir, tree = snapshot
    path = os.path.join(sopro_dir, "model.safetensors")
    jcfg, jparams = JH.load_sopro_checkpoint(path)
    cfg, params = H.load_sopro_checkpoint(path, on_unconsumed="raise")
    assert cfg.to_dict() == jcfg.to_dict() == SoproTTSConfig(**CFG).to_dict()
    leaves_equal(params, jparams)
    leaves_equal(params, tree)

    mpath, mjson = os.path.join(mimi_dir, "model.safetensors"), os.path.join(mimi_dir, "config.json")
    jmcfg, jmparams = JH.load_mimi_checkpoint(mpath, cfg_json=mjson)
    mcfg, mparams = H.load_mimi_checkpoint(mpath, cfg_json=mjson, on_unconsumed="raise")
    assert mcfg.hop_length == jmcfg.hop_length and mcfg.upsampling_ratios == jmcfg.upsampling_ratios
    leaves_equal(mparams, jmparams)


def test_jax_reads_the_port_save_pretrained(pair, snapshot, tmp_path):
    """`save_pretrained` of the port, read by JAX `load_sopro_checkpoint`
    with every tensor consumed, bit for bit; the tokenizer files go too."""
    _, port = pair
    out = str(tmp_path / "saved")
    path = port.save_pretrained(out)
    jcfg, jparams = JH.load_sopro_checkpoint(path, on_unconsumed="raise")
    assert jcfg.to_dict() == port.cfg.to_dict()
    leaves_equal(jparams, snapshot[2])
    assert os.path.exists(os.path.join(out, "tokenizer.json"))
    assert JTextTokenizer(out).encode("hello voice") == port.tokenizer.encode("hello voice")


def test_missing_tensor_raises_naming_it(snapshot, tmp_path):
    sopro_dir, mimi_dir, _ = snapshot
    path = os.path.join(sopro_dir, "model.safetensors")
    flat = H.load_flat_safetensors(path)
    flat.pop("ar.head.weight")
    broken = str(tmp_path / "model.safetensors")
    H.write_safetensors(broken, flat, metadata=H.read_safetensors_metadata(path))
    with pytest.raises(RuntimeError, match="ar.head.weight"):
        H.load_sopro_checkpoint(broken)

    mflat = H.load_flat_safetensors(os.path.join(mimi_dir, "model.safetensors"))
    mflat.pop("decoder.layers.0.conv.weight")
    H.write_safetensors(broken, mflat)
    with pytest.raises(RuntimeError, match="decoder.layers.0.conv.weight"):
        H.load_mimi_checkpoint(broken, cfg_json=os.path.join(mimi_dir, "config.json"))


def test_unconsumed_tensors_follow_the_policy(snapshot, tmp_path):
    sopro_dir, _, _ = snapshot
    path = os.path.join(sopro_dir, "model.safetensors")
    flat = dict(H.load_flat_safetensors(path), stray=np.zeros(3, np.float32))
    extra = str(tmp_path / "model.safetensors")
    H.write_safetensors(extra, flat, metadata=H.read_safetensors_metadata(path))
    with pytest.raises(RuntimeError, match="stray"):
        H.load_sopro_checkpoint(extra, on_unconsumed="raise")
    with pytest.warns(UserWarning, match="stray"):
        H.load_sopro_checkpoint(extra)
    H.load_sopro_checkpoint(extra, on_unconsumed="ignore")


def test_text_tokenizer_ids_equal_jax(snapshot):
    sopro_dir = snapshot[0]
    ours, theirs = TextTokenizer(sopro_dir), JTextTokenizer(sopro_dir)
    for attr in ("pad_id", "bos_id", "eos_id", "vocab_size"):
        assert getattr(ours, attr) == getattr(theirs, attr)
    for text in ("hello world", "voice test hello", "unknown words here", ""):
        assert ours.encode(text) == theirs.encode(text)


def test_from_pretrained_synthesize_matches_jax(pair):
    jtts, port = pair
    assert port.tokenizer.bos_id is not None
    text = "hello world voice"
    for seed in (1, 4):
        jref = jtts.prepare_reference(ref_tokens_tq=REF)
        want = jtts.generate_tokens(text, jref, max_frames=CFG["max_frames"], seed=seed)
        got = port.generate_tokens(text, port.prepare_reference(ref_tokens_tq=REF),
                                   max_frames=CFG["max_frames"], seed=seed)
        np.testing.assert_array_equal(got, want)
        peak_close(port.synthesize(text, ref_tokens_tq=REF, max_frames=CFG["max_frames"], seed=seed),
                   jtts.synthesize(text, ref_tokens_tq=REF, max_frames=CFG["max_frames"], seed=seed))


def test_a_name_that_is_not_a_directory_raises(snapshot):
    with pytest.raises(FileNotFoundError, match="no/such/repo"):
        SoproTTS.from_pretrained("no/such/repo", mimi_repo_id=snapshot[1], device="cpu")
    with pytest.raises(FileNotFoundError, match="kyutai/mimi"):
        SoproTTS.from_pretrained(snapshot[0], device="cpu")


def test_mimi_adapter_matches_jax(snapshot, tmp_path):
    """`MimiCodec.decode_full`, chunked `MimiStreamDecoder.decode_step` and
    `encode_file` against the JAX adapter on the same snapshot."""
    mimi_dir = snapshot[1]
    ours, theirs = MimiCodec.from_pretrained(mimi_dir, device="cpu"), JMimiCodec.from_pretrained(mimi_dir)
    codes = np.random.default_rng(3).integers(0, 32, (9, 8)).astype(np.int32)
    full = theirs.decode_full(codes)
    peak_close(ours.decode_full(codes), full)
    dec, jdec = MimiStreamDecoder(ours), JStreamDecoder(theirs)
    st = jst = None
    parts, jparts = [], []
    for lo, hi in ((0, 4), (4, 9)):
        w, st = dec.decode_step(codes[lo:hi], st)
        jw, jst = jdec.decode_step(codes[lo:hi], jst)
        parts.append(w)
        jparts.append(np.asarray(jw))
    peak_close(np.concatenate(parts, axis=1), np.concatenate(jparts, axis=1))
    peak_close(np.concatenate(parts, axis=1), full)

    wav = (np.random.default_rng(4).standard_normal(24 * 40) * 0.3).astype(np.float32)
    path = str(tmp_path / "ref.wav")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(24000)
        f.writeframes((np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes())
    np.testing.assert_array_equal(ours.encode_file(path), theirs.encode_file(path))


def test_runtime_config_takes_the_jax_fields():
    """C3: the four JAX fields are accepted; bfloat16 is accepted and a
    dtype other than float32 or bfloat16 raises; use_pallas_vocoder=False
    takes the plain version on the CPU."""
    rt = RuntimeConfig(compute_dtype="float32", param_dtype="float32", ar_chunk=4,
                       use_pallas_vocoder=False)
    assert rt.ar_chunk == 4
    for name in ("compute_dtype", "param_dtype"):
        assert getattr(RuntimeConfig(**{name: "bfloat16"}), name) == "bfloat16"
        with pytest.raises(ValueError, match=name):
            RuntimeConfig(**{name: "float16"})
    tree, mimi, _, cfg, _, mcfg = make_trees(seed=2)
    model, codec = W.sopro_params_from_jax(tree, cfg, "cpu"), W.mimi_params_from_jax(mimi, mcfg, "cpu")
    from sopro_tpu_torch.tokenizer import SimpleCharTokenizer

    off = SoproTTS(Engine(model, codec, rt), cfg, SimpleCharTokenizer(), rt)
    on = SoproTTS(Engine(model, codec), cfg, SimpleCharTokenizer())
    np.testing.assert_array_equal(off.synthesize("hi there", ref_tokens_tq=REF, max_frames=12),
                                  on.synthesize("hi there", ref_tokens_tq=REF, max_frames=12))


def test_from_random_without_codec():
    """C4: `with_codec=False` decodes tokens; codec calls raise naming the
    missing codec."""
    kw = dict(seed=3, device="cpu")
    cfg = SoproTTSConfig(**CFG)
    from sopro_tpu_torch.codec.mimi_config import MimiConfig

    bare = SoproTTS.from_random(cfg, with_codec=False, **kw)
    full = SoproTTS.from_random(cfg, mimi_cfg=MimiConfig(**SMALL_MIMI), **kw)
    assert bare.engine.mimi is None
    ref = bare.prepare_reference(ref_tokens_tq=REF)
    np.testing.assert_array_equal(
        bare.generate_tokens("hi", ref, max_frames=12, seed=1),
        full.generate_tokens("hi", full.prepare_reference(ref_tokens_tq=REF), max_frames=12, seed=1),
    )
    for call in (lambda: bare.synthesize("hi", ref=ref, max_frames=12),
                 lambda: bare.synthesize_batch(["hi", "yo"], ref=ref, max_frames=12),
                 lambda: list(bare.stream("hi", ref=ref, max_frames=12)),
                 lambda: bare.encode_reference(ref_audio_path="x.wav")):
        with pytest.raises(RuntimeError, match="codec"):
            call()


def test_package_surface_and_imports_leave_jax_out():
    """The package exports and the new modules import neither JAX nor the
    JAX package (checked in a fresh interpreter); `import sopro_tpu_torch`
    stays light."""
    code = (
        "import sys, sopro_tpu_torch\n"
        "assert sopro_tpu_torch.__version__ == '1.5.0'\n"
        "assert 'torch' not in sys.modules, 'the package import loaded torch'\n"
        "from sopro_tpu_torch import SoproTTS, SoproTTSConfig, RuntimeConfig\n"
        "import sopro_tpu_torch.hub, sopro_tpu_torch.tokenizer, sopro_tpu_torch.codec.convert\n"
        "import sopro_tpu_torch.codec.adapter, sopro_tpu_torch.serve, sopro_tpu_torch.serve.scheduler\n"
        "import sopro_tpu_torch.serve.server, sopro_tpu_torch.serve.server_stdlib\n"
        "from sopro_tpu_torch.serve import ContinuousBatcher, SessionHandle\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'sopro_tpu' or m.startswith('sopro_tpu.') or m == 'transformers']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
