"""Checkpoint files (counterpart: sopro_tpu/hub.py): safetensors read and
written with numpy and `struct` alone, the config embedded in a checkpoint,
and the flat-name <-> tree converters for the Sopro model and the Mimi
codec.

Checkpoint contract (the JAX package's and the reference's):
* `model.safetensors` with the model config as JSON in the safetensors
  `__metadata__["cfg"]` field;
* torch-layout tensors under the reference module names (e.g.
  `ar.blocks.0.dw.dw.weight` [D, 1, k]); unknown config keys are dropped.

The converters map those names to the parameter tree of the JAX package's
layout ([k, 1, D] convs, [in, out] linears) that `weights.py` turns into the
port's modules. A snapshot is a local directory or a hub repo id that
`download_repo` resolves (through `huggingface_hub`, downloaded or cached).

safetensors: an 8-byte little-endian header length, a JSON header
{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{str: str}} padded with spaces to a multiple of 8, then the raw
little-endian tensor bytes back to back.
"""

from __future__ import annotations

import json
import os
import struct
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from sopro_tpu_torch.codec.mimi_config import MimiConfig
from sopro_tpu_torch.config import SoproTTSConfig

Array = np.ndarray
SD = Dict[str, Array]

_DTYPES = {
    "F64": np.dtype("<f8"), "F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
    "I64": np.dtype("<i8"), "I32": np.dtype("<i4"), "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"), "U8": np.dtype("u1"), "U16": np.dtype("<u2"),
    "U32": np.dtype("<u4"), "U64": np.dtype("<u8"), "BOOL": np.dtype("?"),
}
_NAMES = {dt: name for name, dt in _DTYPES.items()}


def download_repo(repo_id: str, *, revision: Optional[str] = None,
                  cache_dir: Optional[str] = None, token: Optional[str] = None) -> str:
    """A snapshot's local directory: `repo_id` itself where it is a
    directory, else `huggingface_hub.snapshot_download(repo_id=, revision=,
    cache_dir=, token=)`, which downloads it or, offline (HF_HUB_OFFLINE=1),
    finds it in the hub's cache. The hub package is imported only for a
    name that is not a directory. A name that neither is a directory nor
    resolves (not cached offline, not a repo id, or no `huggingface_hub`
    installed) raises FileNotFoundError naming it."""
    if os.path.isdir(repo_id):
        return repo_id
    try:
        from huggingface_hub import snapshot_download
        from huggingface_hub.utils import HFValidationError
    except ImportError as e:
        raise FileNotFoundError(
            f"{repo_id!r} is not a local snapshot directory, and huggingface_hub is not "
            "installed to fetch it from the hub or its cache"
        ) from e
    try:
        return snapshot_download(repo_id=repo_id, revision=revision, cache_dir=cache_dir,
                                 token=token)
    except (FileNotFoundError, HFValidationError) as e:
        # offline and not cached (LocalEntryNotFoundError), or not a repo id (a missing path)
        raise FileNotFoundError(
            f"{repo_id!r} (revision {revision or 'main'}) is not a local snapshot directory "
            f"and the hub did not resolve it: {e}"
        ) from e


def _read_header(f) -> Tuple[Dict[str, Any], int]:
    (n,) = struct.unpack("<Q", f.read(8))
    return json.loads(f.read(n).decode("utf-8")), 8 + n


def read_safetensors_metadata(path: str) -> Dict[str, str]:
    """The `__metadata__` block of a safetensors header."""
    with open(path, "rb") as f:
        header, _ = _read_header(f)
    return {str(k): str(v) for k, v in (header.get("__metadata__") or {}).items()}


def load_cfg_from_safetensors(path: str) -> SoproTTSConfig:
    meta = read_safetensors_metadata(path)
    if "cfg" not in meta:
        raise RuntimeError(f"No 'cfg' metadata found in {path}.")
    return SoproTTSConfig.from_dict(json.loads(meta["cfg"]))


def load_flat_safetensors(path: str) -> SD:
    """Flat name -> numpy array (writable, torch layouts kept); BF16
    tensors widen to float32."""
    with open(path, "rb") as f:
        header, start = _read_header(f)
        buf = bytearray(os.fstat(f.fileno()).st_size - start)
        f.readinto(buf)
    out: SD = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        shape = tuple(int(x) for x in info["shape"])
        if info["dtype"] == "BF16":
            bits = np.frombuffer(buf, np.dtype("<u2"), (hi - lo) // 2, lo)
            arr = (bits.astype(np.uint32) << 16).view(np.float32)
        elif info["dtype"] in _DTYPES:
            dt = _DTYPES[info["dtype"]]
            arr = np.frombuffer(buf, dt, (hi - lo) // dt.itemsize, lo)
            if not arr.flags.aligned:
                arr = arr.copy()
        else:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
        out[name] = arr.reshape(shape)
    return out


def write_safetensors(path: str, flat: SD, metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `flat` as safetensors: tensors by itemsize (largest first),
    then name, so every tensor starts aligned to its itemsize."""
    arrays = {k: np.ascontiguousarray(v) for k, v in flat.items()}
    for k, a in arrays.items():
        if a.dtype.newbyteorder("<") not in _NAMES:
            raise ValueError(f"write_safetensors: {k} has unsupported dtype {a.dtype}")
    order = sorted(arrays, key=lambda k: (-arrays[k].dtype.itemsize, k))
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    off = 0
    for k in order:
        a = arrays[k]
        header[k] = {"dtype": _NAMES[a.dtype.newbyteorder("<")], "shape": list(a.shape),
                     "data_offsets": [off, off + a.nbytes]}
        off += a.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for k in order:
            f.write(arrays[k].astype(arrays[k].dtype.newbyteorder("<"), copy=False).tobytes())


class TrackedStateDict(dict):
    """A flat checkpoint dict that records every key a converter reads, so
    a loader can check coverage: `unconsumed()` names every tensor the
    converter never touched (a converter dropping a real weight fails
    silently otherwise)."""

    def __init__(self, sd: SD):
        super().__init__(sd)
        self.consumed: set = set()

    def __getitem__(self, k):
        self.consumed.add(k)
        return super().__getitem__(k)

    def unconsumed(self) -> List[str]:
        return sorted(set(self.keys()) - self.consumed)


def _coverage_check(flat: TrackedStateDict, path: str, on_unconsumed: str) -> None:
    extra = flat.unconsumed()
    if not extra:
        return
    msg = (f"checkpoint {path}: {len(extra)} tensor(s) not consumed by the converter "
           f"(silent weight drop?): {extra[:8]}" + (" ..." if len(extra) > 8 else ""))
    if on_unconsumed == "raise":
        raise RuntimeError(msg)
    if on_unconsumed == "warn":
        warnings.warn(msg, stacklevel=3)


# --------------------------------------------------------------------------
# flat reference-named state dict <-> tree
# --------------------------------------------------------------------------


def _lin(sd: SD, name: str) -> Dict[str, Array]:
    p = {"w": np.ascontiguousarray(sd[f"{name}.weight"].T)}
    if f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"]
    return p


def _rms(sd: SD, name: str) -> Dict[str, Array]:
    return {"scale": sd[f"{name}.weight"]}


def _ln(sd: SD, name: str) -> Dict[str, Array]:
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _dw(sd: SD, name: str) -> Dict[str, Array]:
    # torch depthwise Conv1d [D, 1, k] -> HIO [k, 1, D]
    p = {"w": np.ascontiguousarray(np.transpose(sd[f"{name}.weight"], (2, 1, 0)))}
    if f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"]
    return p


def _emb(sd: SD, name: str) -> Dict[str, Array]:
    return {"emb": sd[f"{name}.weight"]}


def _ssmlite(sd: SD, name: str) -> Dict[str, Any]:
    return {
        "norm": _rms(sd, f"{name}.norm"),
        "glu": {"pro": _lin(sd, f"{name}.glu.pro")},
        "dw": _dw(sd, f"{name}.dw.dw"),
        "ff_norm": _rms(sd, f"{name}.ff.0"),
        "ff1": _lin(sd, f"{name}.ff.1"),
        "ff2": _lin(sd, f"{name}.ff.3"),
    }


def _xattn(sd: SD, name: str) -> Dict[str, Any]:
    return {
        "nq": _rms(sd, f"{name}.nq"), "nkv": _rms(sd, f"{name}.nkv"),
        "q": _lin(sd, f"{name}.q_proj"), "k": _lin(sd, f"{name}.k_proj"),
        "v": _lin(sd, f"{name}.v_proj"), "out": _lin(sd, f"{name}.out_proj"),
        "gate": sd[f"{name}.gate"],
    }


def _layers(sd: SD, prefix: str, n: int, fn) -> List[Any]:
    return [fn(sd, f"{prefix}.{i}") for i in range(n)]


def sopro_params_from_flat(sd: SD, cfg: SoproTTSConfig) -> Dict[str, Any]:
    """Reference checkpoint names -> the Sopro tree (a missing tensor raises
    KeyError naming it)."""
    has_xattn = [(i + 1) % int(cfg.ar_text_attn_freq) == 0 for i in range(cfg.n_layers_ar)]
    stages = cfg.stage_order()
    stage_idx = cfg.stage_indices()
    nar = {
        "blocks": _layers(sd, "nar.blocks", cfg.n_layers_nar, _ssmlite),
        "norm": _rms(sd, "nar.norm"),
        "pre": _lin(sd, "nar.pre"),
        "stage_emb": _emb(sd, "nar.stage_emb"),
        "adapter": {
            "norm": _rms(sd, "nar.adapter.norm"),
            "mlp1": _lin(sd, "nar.adapter.mlp.0"),
            "mlp2": _lin(sd, "nar.adapter.mlp.2"),
        },
        "heads": {s: [_lin(sd, f"nar.heads.{s}.{i}") for i in range(len(stage_idx[s]))]
                  for s in stages},
        "head_id_emb": {s: _emb(sd, f"nar.head_id_emb.{s}") for s in stages},
        "mix": {s: sd[f"nar.mix.{s}"] for s in stages},
    }
    return {
        "text_enc": {
            "embed": _emb(sd, "text_enc.embed.emb"),
            "layers": _layers(sd, "text_enc.layers", cfg.n_layers_text, _ssmlite),
            "norm": _rms(sd, "text_enc.norm"),
        },
        "cb_embed": _emb(sd, "cb_embed.emb"),
        "nar_prev_cb_weights": sd["nar_prev_cb_weights"],
        "token2sv": {
            "emb": _emb(sd, "token2sv.emb"),
            "cb_weights": sd["token2sv.cb_weights"],
            "conv1": _dw(sd, "token2sv.enc.0.dw"),
            "conv2": _dw(sd, "token2sv.enc.3.dw"),
            "pool": {"a1": _lin(sd, "token2sv.pool.attn.0"), "a2": _lin(sd, "token2sv.pool.attn.2")},
            "proj": _lin(sd, "token2sv.proj"),
        },
        "spk_film": {
            "mlp1": _lin(sd, "spk_film.mlp.0"),
            "mlp2": _lin(sd, "spk_film.mlp.2"),
            "norm": _ln(sd, "spk_film.norm"),
        },
        "ar": {
            "blocks": _layers(sd, "ar.blocks", cfg.n_layers_ar, _ssmlite),
            "xattn": [_xattn(sd, f"ar.x_attns.{i}") if has_xattn[i] else None
                      for i in range(cfg.n_layers_ar)],
            "norm": _rms(sd, "ar.norm"),
            "head": _lin(sd, "ar.head"),
        },
        "nar": nar,
        "cond_norm": _rms(sd, "cond_norm"),
        "ref_enc_blocks": _layers(sd, "ref_enc_blocks", cfg.ref_enc_layers, _ssmlite),
        "ref_enc_norm": _rms(sd, "ref_enc_norm"),
        "ref_xattn": _layers(sd, "ref_xattn.blocks", cfg.ref_xattn_layers, _xattn),
        "ref_cb_weights": sd["ref_cb_weights"],
    }


def sopro_params_to_flat(params: Dict[str, Any], cfg: SoproTTSConfig) -> SD:
    """The inverse of `sopro_params_from_flat`: the Sopro tree ->
    reference-named, torch-layout flat dict."""
    out: SD = {}

    def lin(name, p):
        out[f"{name}.weight"] = np.ascontiguousarray(np.asarray(p["w"]).T)
        if "b" in p:
            out[f"{name}.bias"] = np.asarray(p["b"])

    def rms(name, p):
        out[f"{name}.weight"] = np.asarray(p["scale"])

    def ln(name, p):
        out[f"{name}.weight"] = np.asarray(p["scale"])
        out[f"{name}.bias"] = np.asarray(p["bias"])

    def dw(name, p):
        out[f"{name}.weight"] = np.ascontiguousarray(np.transpose(np.asarray(p["w"]), (2, 1, 0)))
        if "b" in p:
            out[f"{name}.bias"] = np.asarray(p["b"])

    def emb(name, p):
        out[f"{name}.weight"] = np.asarray(p["emb"])

    def ssm(name, p):
        rms(f"{name}.norm", p["norm"])
        lin(f"{name}.glu.pro", p["glu"]["pro"])
        dw(f"{name}.dw.dw", p["dw"])
        rms(f"{name}.ff.0", p["ff_norm"])
        lin(f"{name}.ff.1", p["ff1"])
        lin(f"{name}.ff.3", p["ff2"])

    def xattn(name, p):
        rms(f"{name}.nq", p["nq"])
        rms(f"{name}.nkv", p["nkv"])
        for key, sub in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "out_proj")):
            lin(f"{name}.{sub}", p[key])
        out[f"{name}.gate"] = np.asarray(p["gate"])

    out["nar_prev_cb_weights"] = np.asarray(params["nar_prev_cb_weights"])
    out["ref_cb_weights"] = np.asarray(params["ref_cb_weights"])
    emb("text_enc.embed.emb", params["text_enc"]["embed"])
    for i, bp in enumerate(params["text_enc"]["layers"]):
        ssm(f"text_enc.layers.{i}", bp)
    rms("text_enc.norm", params["text_enc"]["norm"])
    emb("cb_embed.emb", params["cb_embed"])
    t2 = params["token2sv"]
    out["token2sv.cb_weights"] = np.asarray(t2["cb_weights"])
    emb("token2sv.emb", t2["emb"])
    dw("token2sv.enc.0.dw", t2["conv1"])
    dw("token2sv.enc.3.dw", t2["conv2"])
    lin("token2sv.pool.attn.0", t2["pool"]["a1"])
    lin("token2sv.pool.attn.2", t2["pool"]["a2"])
    lin("token2sv.proj", t2["proj"])
    lin("spk_film.mlp.0", params["spk_film"]["mlp1"])
    lin("spk_film.mlp.2", params["spk_film"]["mlp2"])
    ln("spk_film.norm", params["spk_film"]["norm"])
    for i, bp in enumerate(params["ar"]["blocks"]):
        ssm(f"ar.blocks.{i}", bp)
    for i, xp in enumerate(params["ar"]["xattn"]):
        if xp is not None:
            xattn(f"ar.x_attns.{i}", xp)
    rms("ar.norm", params["ar"]["norm"])
    lin("ar.head", params["ar"]["head"])
    nar = params["nar"]
    for i, bp in enumerate(nar["blocks"]):
        ssm(f"nar.blocks.{i}", bp)
    rms("nar.norm", nar["norm"])
    lin("nar.pre", nar["pre"])
    emb("nar.stage_emb", nar["stage_emb"])
    rms("nar.adapter.norm", nar["adapter"]["norm"])
    lin("nar.adapter.mlp.0", nar["adapter"]["mlp1"])
    lin("nar.adapter.mlp.2", nar["adapter"]["mlp2"])
    for s in cfg.stage_order():
        for i, hp in enumerate(nar["heads"][s]):
            lin(f"nar.heads.{s}.{i}", hp)
        emb(f"nar.head_id_emb.{s}", nar["head_id_emb"][s])
        out[f"nar.mix.{s}"] = np.asarray(nar["mix"][s])
    rms("cond_norm", params["cond_norm"])
    for i, bp in enumerate(params["ref_enc_blocks"]):
        ssm(f"ref_enc_blocks.{i}", bp)
    rms("ref_enc_norm", params["ref_enc_norm"])
    for i, xp in enumerate(params["ref_xattn"]):
        xattn(f"ref_xattn.blocks.{i}", xp)
    return out


def save_sopro_checkpoint(path: str, params: Dict[str, Any], cfg: SoproTTSConfig) -> None:
    """A reference-compatible model.safetensors (float32) with the cfg
    embedded as JSON metadata."""
    flat = {k: np.asarray(v, np.float32) for k, v in sopro_params_to_flat(params, cfg).items()}
    write_safetensors(path, flat, metadata={"cfg": json.dumps(cfg.to_dict())})


def load_sopro_checkpoint(path: str, *, on_unconsumed: str = "warn"):
    """model.safetensors -> (cfg, Sopro tree). A tensor the converter needs
    and the file lacks raises RuntimeError naming it; tensors the converter
    never reads go by `on_unconsumed`: "warn" (default), "raise" or
    "ignore"."""
    cfg = load_cfg_from_safetensors(path)
    flat = TrackedStateDict(load_flat_safetensors(path))
    try:
        params = sopro_params_from_flat(flat, cfg)
    except KeyError as e:
        raise RuntimeError(
            f"checkpoint {path} is missing tensor {e} required by its own embedded cfg; "
            "refusing a partial load"
        ) from e
    _coverage_check(flat, path, on_unconsumed)
    return cfg, params


def load_mimi_checkpoint(path: str, cfg_json: Optional[str] = None, *,
                         on_unconsumed: str = "warn"):
    """A Mimi model.safetensors (+ config.json) -> (MimiConfig, Mimi tree),
    with `load_sopro_checkpoint`'s coverage contract; the encoder tensors are
    consumed (reference audio runs the encoder)."""
    from sopro_tpu_torch.codec.convert import convert_mimi_state_dict

    if cfg_json and os.path.exists(cfg_json):
        with open(cfg_json) as f:
            cfg = MimiConfig.from_dict(json.load(f))
    else:
        cfg = MimiConfig()
    flat = TrackedStateDict(load_flat_safetensors(path))
    try:
        params = convert_mimi_state_dict(flat, cfg)
    except KeyError as e:
        raise RuntimeError(
            f"Mimi checkpoint {path} is missing tensor {e}; refusing a partial load"
        ) from e
    _coverage_check(flat, path, on_unconsumed)
    return cfg, params


# --------------------------------------------------------------------------
# CSM (transformers' CsmForConditionalGeneration names)
# --------------------------------------------------------------------------

CSM_CODEC_PREFIX = "codec_model."


def _csm_transformer(sd: SD, prefix: str, n: int) -> Dict[str, Any]:
    def layer(i):
        p = f"{prefix}.layers.{i}"
        attn = [sd[f"{p}.self_attn.{x}_proj.weight"] for x in ("q", "k", "v")]
        mlp = [sd[f"{p}.mlp.{x}_proj.weight"] for x in ("gate", "up")]
        return {"ln1": sd[f"{p}.input_layernorm.weight"],
                "ln2": sd[f"{p}.post_attention_layernorm.weight"],
                "qkv": np.concatenate(attn, axis=0), "o": sd[f"{p}.self_attn.o_proj.weight"],
                "gate_up": np.concatenate(mlp, axis=0), "down": sd[f"{p}.mlp.down_proj.weight"]}

    return {"layers": [layer(i) for i in range(n)], "norm": sd[f"{prefix}.norm.weight"]}


def csm_params_from_flat(sd: SD, cfg) -> Dict[str, Any]:
    """transformers' CSM names (the codec's `codec_model.*` aside) -> the
    tree of `models.csm` (a missing tensor raises KeyError naming it). The
    depth decoder's embedding table is tied to the backbone's audio table:
    a checkpoint may hold both names or the backbone's alone."""
    audio = sd["backbone_model.embed_tokens.embed_audio_tokens.weight"]
    tied = "depth_decoder.model.embed_tokens.weight"
    if tied in sd and not np.array_equal(sd[tied], audio):
        raise ValueError(f"{tied} differs from the backbone's audio table it is tied to")
    depth = _csm_transformer(sd, "depth_decoder.model", cfg.depth.num_hidden_layers)
    depth["proj"] = sd["depth_decoder.model.inputs_embeds_projector.weight"]
    return {"text_embed": sd["embed_text_tokens.weight"], "audio_embed": audio,
            "lm_head": sd["lm_head.weight"],
            "backbone": _csm_transformer(sd, "backbone_model", cfg.backbone.num_hidden_layers),
            "depth": depth, "heads": sd["depth_decoder.codebooks_head.weight"]}


def split_codec(sd: SD, prefix: str) -> Tuple[SD, SD]:
    """A state dict holding a Mimi codec under `prefix` -> (the other
    tensors, the codec's under MimiModel's names)."""
    n = len(prefix)
    return ({k: v for k, v in sd.items() if not k.startswith(prefix)},
            {k[n:]: v for k, v in sd.items() if k.startswith(prefix)})


def load_snapshot(local: str) -> Tuple[Dict, SD]:
    """A transformers snapshot directory -> (its config.json, the flat
    state dict of model.safetensors or of the shards its
    model.safetensors.index.json lists)."""
    with open(os.path.join(local, "config.json")) as f:
        cfg = json.load(f)
    index = os.path.join(local, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = ["model.safetensors"]
    flat: SD = {}
    for name in files:
        flat.update(load_flat_safetensors(os.path.join(local, name)))
    return cfg, flat


# --------------------------------------------------------------------------
# Moshi (transformers' MoshiForConditionalGeneration names)
# --------------------------------------------------------------------------

MOSHI_CODEC_PREFIX = "audio_encoder."


def _moshi_layer(sd: SD, p: str) -> Dict[str, Any]:
    """One decoder layer: `q_proj.linear.weight` etc. ([out, in], or [Q, out,
    in] stacks in the depformer), q/k/v stacked on the out axis."""
    attn = [sd[f"{p}.self_attn.{x}_proj.linear.weight"] for x in ("q", "k", "v")]
    return {"ln1": sd[f"{p}.input_layernorm.weight"],
            "ln2": sd[f"{p}.post_attention_layernorm.weight"],
            "qkv": np.concatenate(attn, axis=-2), "o": sd[f"{p}.self_attn.o_proj.linear.weight"],
            "gate_up": sd[f"{p}.mlp.fc1.weight"], "down": sd[f"{p}.mlp.fc2.weight"]}


def moshi_params_from_flat(sd: SD, cfg) -> Dict[str, Any]:
    """transformers' Moshi names (the codec's `audio_encoder.*` aside) -> the
    tree of `models.moshi` (a missing tensor raises KeyError naming it).
    Their q and k rows are already in the rotate-half layout RoPE takes
    here."""
    q = cfg.num_codebooks
    t, d = "decoder.model", "depth_decoder"
    return {
        "text_embed": sd[f"{t}.embed_tokens.weight"],
        "audio_embed": np.stack([sd[f"embed_tokens.{i}.weight"] for i in range(2 * q)]),
        "temporal": {"layers": [_moshi_layer(sd, f"{t}.layers.{i}")
                                for i in range(cfg.temporal.num_hidden_layers)],
                     "norm": sd[f"{t}.norm.weight"]},
        "lm_head": sd["decoder.lm_head.weight"],
        "depth": {"layers": [_moshi_layer(sd, f"{d}.layers.{i}")
                             for i in range(cfg.depth.num_hidden_layers)]},
        "depth_text_embed": sd[f"{d}.text_embed_tokens.weight"],
        "depth_audio_embed": np.stack([sd[f"{d}.embed_tokens.{i}.weight"] for i in range(q - 1)]),
        "depth_proj": sd[f"{d}.input_projections.weight"],
        "heads": sd[f"{d}.lm_heads.weight"],
    }
