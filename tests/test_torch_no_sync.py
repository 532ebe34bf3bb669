"""Nothing between the AR decode and the readback waits for the card.

The fused and batch plans issue the NAR and the Mimi decode while K1 runs;
one host sync there would hold them back until K1 ends. On the CPU a
`TorchDispatchMode` records the ops dispatched inside `sopro.nar` and
`sopro.mimi` (a warmed-up call: the weight packs and the codebook ids are
built) and refuses the ones that on CUDA copy host data to the card or read
the card on the host: `aten.lift_fresh` (a tensor from Python data, a
host-to-device copy), `aten._local_scalar_dense` (`.item()`, `int()`,
`bool()` of a tensor), `aten.nonzero`, `aten.masked_select`, and a
`aten._to_copy` to another device. The CPU run decodes the SEANet with
`seanet_apply` in place of K3; it shares the NAR, the RVQ dequant, the
upsample and the Mimi transformer with the CUDA route, and trips nothing.
On the card, `tests/test_torch_cuda.py::test_no_sync_between_ar_and_readback`
holds the same steps under `torch.cuda.set_sync_debug_mode("error")`.

Also: `cb_sum_embed_subset` with the ids as a device tensor equals the
list-indexed sum bit for bit, on a plain table and on row- and column-split
`Shards` tables, with and without codebook weights; and the NAR's cached ids.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sopro_tpu_torch import engine as E
from sopro_tpu_torch.codec.mimi_config import MimiConfig
from sopro_tpu_torch.config import SoproTTSConfig
from sopro_tpu_torch.models import nar as N
from sopro_tpu_torch.ops import tp as TPO
from sopro_tpu_torch.ops.embeddings import CodebookEmbeddingSpec, cb_sum_embed_subset
from sopro_tpu_torch.tts import SoproTTS

from tests.test_torch_cuda import CFG, SMALL_MIMI

WINDOW = ("sopro.nar", "sopro.mimi")
REFUSED = {"aten.lift_fresh.default", "aten._local_scalar_dense.default",
           "aten.nonzero.default", "aten.masked_select.default"}


class _HostTouch(TorchDispatchMode):
    """Records the refused ops dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        if name in REFUSED:
            self.seen.append(name)
        elif name.startswith("aten._to_copy") and kwargs.get("device") is not None:
            if torch.device(kwargs["device"]) != args[0].device:
                self.seen.append(f"{name} to {kwargs['device']}")
        return func(*args, **kwargs)


def _guard_window(monkeypatch, guard):
    """Run `guard()`'s context inside each step of the window."""
    plain = E.span

    @contextlib.contextmanager
    def span(name):
        with plain(name):
            if name in WINDOW:
                with guard():
                    yield
            else:
                yield

    monkeypatch.setattr(E, "span", span)


def _tts(device):
    torch.manual_seed(0)
    return SoproTTS.from_random(SoproTTSConfig(**CFG), mimi_cfg=MimiConfig(**SMALL_MIMI),
                                device=device)


REF = np.arange(80, dtype=np.int32).reshape(10, 8) % 32
PLANS = {
    "fused": lambda tts, ref: [tts.synthesize("hello there", ref=ref, max_frames=20, seed=1,
                                              fused=True)],
    "batch": lambda tts, ref: tts.synthesize_batch(["hello there", "a second one"], ref=ref,
                                                   max_frames=20, seeds=[1, 2]),
}


@pytest.fixture(scope="module")
def cpu_tts():
    tts = _tts("cpu")
    return tts, tts.prepare_reference(ref_tokens_tq=REF)


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_nar_and_mimi_touch_no_host_data(cpu_tts, plan, monkeypatch):
    tts, ref = cpu_tts
    want = PLANS[plan](tts, ref)
    rec = _HostTouch()
    _guard_window(monkeypatch, lambda: rec)
    got = PLANS[plan](tts, ref)
    assert rec.seen == []
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


def test_the_guard_sees_a_list_of_ids():
    """What the parent did at `cb_sum_embed_subset`'s head: ids from a list."""
    rec = _HostTouch()
    with rec:
        torch.as_tensor([0, 1, 2], dtype=torch.long)
        torch.zeros(2, 3)[:, [0, 2]] = torch.ones(2, 2)
        int(torch.ones(()))
    assert rec.seen == ["aten.lift_fresh.default"] * 2 + ["aten._local_scalar_dense.default"]


def _tables():
    g = torch.Generator().manual_seed(4)
    spec = CodebookEmbeddingSpec(8, 16)
    table = torch.randn(spec.table_size, 12, generator=g)
    return spec, {
        "plain": table,
        "rows": TPO.Shards([table[:50], table[50:97], table[97:]], 0),
        "cols": TPO.Shards([table[:, :5], table[:, 5:]], 1),
    }, g


@pytest.mark.parametrize("layout", ["plain", "rows", "cols"])
@pytest.mark.parametrize("weights", ["none", "all", "subset"])
def test_device_ids_sum_as_the_list_does(layout, weights):
    spec, tables, g = _tables()
    cbs = [0, 1, 2, 5]
    tokens = torch.randint(0, spec.V, (2, 7, len(cbs)), generator=g, dtype=torch.int32)
    w = {"none": None, "all": torch.randn(spec.Q, generator=g),
         "subset": torch.randn(len(cbs), generator=g)}[weights]
    p = {"emb": tables[layout]}
    want = cb_sum_embed_subset(p, spec, tokens, cbs, cb_weights=w)
    got = cb_sum_embed_subset(p, spec, tokens, torch.tensor(cbs), cb_weights=w)
    assert torch.equal(got, want)


def test_nar_ids_are_built_once_per_device_and_weights(cpu_tts):
    tts, _ = cpu_tts
    model = tts.engine.model
    cfg = model.cfg
    ids = model.nar.prev_ids("cpu")
    assert model.nar.prev_ids(torch.device("cpu")) is ids
    before, stage_idx = [0], cfg.stage_indices()
    for stage in cfg.stage_order():
        assert ids[stage].dtype == torch.long and ids[stage].tolist() == before
        assert stage_idx[stage] == list(range(stage_idx[stage][0], stage_idx[stage][-1] + 1))
        before = before + stage_idx[stage]
    assert not ids[cfg.stage_order()[0]].is_inference()
    model.weights_changed()
    assert model.nar.prev_ids("cpu") is not ids
    for stage, t in N.prev_cb_ids(cfg, "cpu").items():
        assert torch.equal(t, ids[stage])
