"""The (dp, tp) training layout (`parallel/mesh.py` rules, `parallel/tensor.py`,
`ops/tp.py`) on the CPU, against the JAX package and the port's unsharded step.

Meshes of CPU devices (`devices=[cpu] * n`) on the port's side; JAX's meshes
on the suite's 8 virtual CPU devices. The small configuration of
tests/test_parallel.py (`TRAIN_CFG`, text vocab 64), weights from JAX's init
with the zero-initialised leaves filled, the training batch `make_batch()`.

Tolerances:
- the specs: every leaf equal to JAX's `param_shardings`;
- the loss against JAX's sharded loss: rtol 2e-5 (JAX's own bar between its
  sharded and unsharded loss);
- each leaf's gathered gradient against the unsharded port: within 1e-4 of
  the leaf's largest |gradient| plus 1e-6 of the largest of all leaves (the
  products sum in another order over the shards);
- the parameters after 2 AdamW steps (lr 1e-3) against the unsharded port:
  at most 1e-4 of the elements differ by more than 1e-6, none by more than
  5e-5 (an element whose gradient is near zero takes a step of up to lr
  whose size its rounding sets);
- checkpoints: parameters and moments bit-identical across layouts; the
  step after a restore into the saving layout bit-identical to continuing,
  in another layout within the step tolerances above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sopro_tpu import train as JT
from sopro_tpu.config import SoproTTSConfig as JCfg
from sopro_tpu.models.sopro import init_sopro_model
from sopro_tpu.parallel import make_mesh as j_make_mesh
from sopro_tpu.parallel import param_shardings as j_param_shardings
from sopro_tpu.parallel.mesh import _path_str as j_path_str
from sopro_tpu.parallel.mesh import batch_sharding as j_batch_sharding

from sopro_tpu_torch import train as T
from sopro_tpu_torch import weights as W
from sopro_tpu_torch.config import SoproTTSConfig
from sopro_tpu_torch.models.base import tree_map
from sopro_tpu_torch.ops import blocks
from sopro_tpu_torch.ops import tp as TPO
from sopro_tpu_torch.parallel import make_mesh, param_shardings
from sopro_tpu_torch.parallel import tensor as TP

from tests.test_torch_cuda import TRAIN_CFG, make_batch, torch_batch

torch.set_num_threads(1)

VOCAB = 64
LR = 1e-3
LOSS_RTOL = 2e-5
GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-6
PARAM_TOL, PARAM_MAX, PARAM_SHARE = 1e-6, 5e-5, 1e-4
LAYOUTS = {"dp2_tp2": (2, 2), "tp1": (1, 1), "tp3": (1, 3), "tp4": (1, 4), "dp4_tp1": (4, 1)}


def cpu_mesh(dp, tp):
    return make_mesh(dp * tp, dp=dp, tp=tp, devices=[torch.device("cpu")] * (dp * tp))


@pytest.fixture(scope="module")
def setup():
    jcfg = JCfg(**TRAIN_CFG)
    tree = jax.tree.map(np.array, init_sopro_model(jax.random.PRNGKey(0), jcfg, VOCAB))
    W.fill_zero_inits(tree, None, 100)
    cfg = SoproTTSConfig(**TRAIN_CFG)
    ref = W.sopro_params_from_jax(tree, cfg, "cpu")
    loss, _ = T.loss_fn(ref, torch_batch(make_batch()))
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in ref.named_parameters()}
    return dict(tree=tree, jcfg=jcfg, cfg=cfg, grads=grads)


def fresh(setup, other=False):
    """The setup's model, or (`other`) one of other weights in the same tree
    order (an optimizer's state is indexed in the model's parameter order)."""
    tree = setup["tree"]
    if other:
        tree = tree_map(lambda a: np.asarray(a * 0.5 + 0.25, np.float32), tree)
    return W.sopro_params_from_jax(tree, setup["cfg"], "cpu")


def sharded(setup, dp, tp):
    model = fresh(setup)
    return TP.shard_train_state(cpu_mesh(dp, tp), model, T.make_optimizer(model, lr=LR))


def flat_specs(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat_specs(sub, path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in flat_specs(sub, path + (str(i),)).items()}
    return {} if tree is None else {"/".join(path): tree}


def jax_specs(mesh, tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(j_param_shardings(mesh, tree))
    return {j_path_str(p): tuple(s.spec) for p, s in flat}


# (dp, tp) of the JAX mesh on the 8 virtual devices, per tp
JAX_MESHES = {2: (4, 2), 3: (1, 3), 4: (2, 4)}


@pytest.mark.parametrize("tp", [2, 3, 4])
@pytest.mark.parametrize("width", ["toy", "flagship"])
def test_param_shardings_match_jax(setup, tp, width):
    """Every leaf's spec equals JAX's, on the port's own tree at the toy
    shapes and on the shapes of JAX's flagship init (eval_shape: nothing is
    allocated)."""
    dp, _ = JAX_MESHES[tp]
    if width == "toy":
        jtree, ptree = setup["tree"], W.sopro_tree(fresh(setup))
    else:
        jtree = jax.eval_shape(lambda: init_sopro_model(jax.random.PRNGKey(0), JCfg(), 2048))
        ptree = jtree
    want = jax_specs(j_make_mesh(dp * tp, dp=dp, tp=tp), jtree)
    got = flat_specs(param_shardings(cpu_mesh(dp, tp), ptree))
    assert got == want
    if width == "flagship" and tp == 2:
        for path, spec in {
            "ar/blocks/0/ff1/w": (None, "tp"), "nar/blocks/1/ff2/w": ("tp", None),
            "text_enc/layers/0/glu/pro/w": (None, "tp"), "ar/head/w": ("tp", None),
            "nar/heads/B/0/w": (None, "tp"), "cb_embed/emb": (None, "tp"),
            "token2sv/emb/emb": ("tp", None), "text_enc/embed/emb": ("tp", None),
            "ar/head/b": (), "ref_xattn/0/gate": (), "nar/pre/w": (),
        }.items():
            assert got[path] == spec, path
    if width == "toy" and tp == 3:
        # the divisibility guard: tp = 3 divides neither 4D = 256 nor 2D = 128
        for path in ("ar/blocks/0/ff1/w", "ar/blocks/0/ff2/w", "nar/blocks/0/glu/pro/w",
                     "nar/heads/B/0/w", "cb_embed/emb", "text_enc/embed/emb"):
            assert got[path] == (), path
        state, _ = sharded(setup, 1, 3)
        assert len(state.leaves["ar/blocks/0/ff1/w"]) == 1


def test_sharded_loss_matches_jax_sharded_loss(setup):
    """The port's loss on (dp=2, tp=2) against JAX's loss_fn on its
    make_mesh(4, dp=2, tp=2) with param_shardings / batch_sharding."""
    nb = make_batch()
    jmesh = j_make_mesh(4, dp=2, tp=2)
    with jmesh:
        jp = jax.device_put(jax.tree.map(jnp.asarray, setup["tree"]),
                            j_param_shardings(jmesh, setup["tree"]))
        jb = JT.TrainBatch(*(jax.device_put(jnp.asarray(nb[k]), j_batch_sharding(jmesh))
                             for k in JT.TrainBatch._fields))
        _, want = jax.jit(lambda p, b: JT.loss_fn(p, setup["jcfg"], b))(jp, jb)
    state, _ = sharded(setup, 2, 2)
    _, got = TP.loss_fn(state, torch_batch(nb))
    for k in ("loss", "ar_loss", "nar_loss"):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=LOSS_RTOL, err_msg=k)


def grad_errors(state, want):
    """Each leaf's gathered gradient's error over its tolerance."""
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in want.values())
    out = {}
    for lay in state.layouts:
        got = lay.join([p.grad for p in state.leaves[lay.path]])
        ref = want[lay.name]
        out[lay.name] = float((got - ref).abs().max()) / (GRAD_TOL * float(ref.abs().max()) + floor)
    return out


def assert_params_close(got, want, what):
    diff = torch.cat([(got[n] - want[n]).abs().flatten() for n in want])
    assert float(diff.max()) <= PARAM_MAX, (what, float(diff.max()))
    assert int((diff > PARAM_TOL).sum()) <= PARAM_SHARE * diff.numel(), (what, int((diff > PARAM_TOL).sum()))


@pytest.mark.parametrize("layout", ["dp2_tp2", "tp3", "tp4", "dp4_tp1"])
def test_gradients_and_two_steps_match_unsharded(setup, layout):
    """At tp = 2 and 4 the toy AR head (vocab 33) splits on d_model, at tp = 3
    on its vocab (with the vocab-parallel cross-entropy) while the FFN, GLU
    and NAR heads replicate; the codebook table splits on its columns and
    the Token2SV and text tables on their rows, except at tp = 3, where
    Token2SV's splits on its columns and the other two replicate."""
    dp, tp = LAYOUTS[layout]
    state, opt = sharded(setup, dp, tp)
    loss, _ = TP.loss_fn(state, torch_batch(make_batch()))
    loss.backward()
    errs = grad_errors(state, setup["grads"])
    assert len(errs) == len(setup["grads"]) and max(errs.values()) <= 1.0, max(errs.items(), key=lambda kv: kv[1])

    plain = fresh(setup)
    plain_step = T.make_train_step(plain, T.make_optimizer(plain, lr=LR))
    state, opt = sharded(setup, dp, tp)
    step = TP.make_train_step(state, opt)
    batch = torch_batch(make_batch())
    for _ in range(2):
        got, want = step(batch), plain_step(batch)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)
    assert_params_close(state.full_leaves(), {n: p.detach() for n, p in plain.named_parameters()},
                        layout)


def optimizer_state(state, opt):
    return state.train_state_dict(opt)["optimizer"]["state"]


def test_checkpoint_restores_across_layouts(setup, tmp_path):
    """Save under (dp=2, tp=2) after 2 steps; restore under tp = 2, tp = 1,
    tp = 4 and into an unsharded model: parameters and moments equal bit for
    bit, and the third step equals continuing (bit for bit in the saving
    layout)."""
    batch = torch_batch(make_batch())
    state, opt = sharded(setup, 2, 2)
    step = TP.make_train_step(state, opt)
    for _ in range(2):
        step(batch)
    path = str(tmp_path / "train.pt")
    T.save_train_checkpoint(path, state, opt, step=2)
    saved_params, saved_moments = state.full_leaves(), optimizer_state(state, opt)
    want = step(batch)
    want_params = state.full_leaves()

    # the file is the unsharded format: an unsharded model and AdamW read it as their own
    plain = fresh(setup, other=True)
    plain_opt = T.make_optimizer(plain, lr=LR)
    assert T.restore_train_checkpoint(path, plain, plain_opt) == 2
    for n, p in plain.named_parameters():
        assert torch.equal(p.detach(), saved_params[n]), n
    plain_state = plain_opt.state_dict()["state"]
    assert plain_state.keys() == saved_moments.keys()
    for i, st in saved_moments.items():
        for k, v in st.items():
            assert torch.equal(plain_state[i][k].cpu(), v), (i, k)
    got = T.make_train_step(plain, plain_opt)(batch)
    assert_params_close({n: p.detach() for n, p in plain.named_parameters()}, want_params, "plain")

    for layout in ("dp2_tp2", "tp1", "tp4"):
        dp, tp = LAYOUTS[layout]
        template = fresh(setup, other=True)
        r_state, r_opt, n = T.restore_train_checkpoint(
            path, template, T.make_optimizer(template, lr=LR), mesh=cpu_mesh(dp, tp))
        assert n == 2
        for name, t in r_state.full_leaves().items():
            assert torch.equal(t, saved_params[name]), (layout, name)
        moments = optimizer_state(r_state, r_opt)
        for i, st in saved_moments.items():
            for k, v in st.items():
                assert torch.equal(moments[i][k], v), (layout, i, k)
        got = TP.make_train_step(r_state, r_opt)(batch)
        if layout == "dp2_tp2":
            assert all(torch.equal(got[k], want[k]) for k in want), layout
            assert all(torch.equal(t, want_params[n]) for n, t in r_state.full_leaves().items())
        else:
            for k in want:
                np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL)
            assert_params_close(r_state.full_leaves(), want_params, layout)


@pytest.mark.parametrize("layout", ["dp2_tp2", "tp4"])
def test_unsharded_checkpoint_restores_into_a_tp_layout(setup, tmp_path, layout):
    """The reverse: an unsharded model's checkpoint after 2 steps restored
    into a tp layout, parameters and moments bit for bit, and the third step
    within the step tolerances of the unsharded one's."""
    batch = torch_batch(make_batch())
    plain = fresh(setup)
    opt = T.make_optimizer(plain, lr=LR)
    step = T.make_train_step(plain, opt)
    for _ in range(2):
        step(batch)
    path = str(tmp_path / "plain.pt")
    T.save_train_checkpoint(path, plain, opt, step=2)
    saved = {n: p.detach().clone() for n, p in plain.named_parameters()}
    saved_moments = opt.state_dict()["state"]
    dp, tp = LAYOUTS[layout]
    template = fresh(setup, other=True)
    state, r_opt, n = T.restore_train_checkpoint(
        path, template, T.make_optimizer(template, lr=LR), mesh=cpu_mesh(dp, tp))
    assert n == 2
    for name, t in state.full_leaves().items():
        assert torch.equal(t, saved[name]), name
    moments = optimizer_state(state, r_opt)
    assert moments.keys() == saved_moments.keys()
    for i, st in saved_moments.items():
        for k, v in st.items():
            assert torch.equal(moments[i][k], v), (i, k)
    got, want = TP.make_train_step(state, r_opt)(batch), step(batch)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL)
    assert_params_close(state.full_leaves(), {n: p.detach() for n, p in plain.named_parameters()},
                        layout)


def test_glu_halves_shard_each_half():
    """Each shard of a GLU projection holds its block of both halves; the
    sharded gate equals the whole one, and gathering inverts the split."""
    rng = np.random.default_rng(3)
    d, tp = 8, 2
    full = {"w": torch.from_numpy(rng.standard_normal((d, 2 * d)).astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal(2 * d).astype(np.float32))}
    mesh = cpu_mesh(1, tp)
    lays = {k: TP.leaf_layout(k, f"ar/blocks/0/glu/pro/{k}", v.shape, mesh) for k, v in full.items()}
    parts = {k: lays[k].split(v, tp) for k, v in full.items()}
    w = full["w"]
    assert torch.equal(parts["w"][0], torch.cat([w[:, :4], w[:, 8:12]], dim=1))
    assert torch.equal(parts["w"][1], torch.cat([w[:, 4:8], w[:, 12:]], dim=1))
    for k in full:
        assert torch.equal(lays[k].join(parts[k]), full[k])
    x = torch.from_numpy(rng.standard_normal((2, 5, d)).astype(np.float32))
    got = blocks.glu({"pro": {k: TPO.Shards(parts[k], -1) for k in full}}, x)
    torch.testing.assert_close(got, blocks.glu({"pro": full}, x), rtol=1e-6, atol=1e-6)


def test_ar_head_row_split_and_vocab_parallel_nll():
    """The AR head split on d_model (an odd vocab) sums its partial logits
    to the whole product; the vocab-parallel NLL of logits split on the
    vocab equals log_softmax's."""
    rng = np.random.default_rng(4)
    d, v = 16, 33
    w = torch.from_numpy(rng.standard_normal((d, v)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(v).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 7, d)).astype(np.float32))
    lay = TP.leaf_layout("ar.head__w", "ar/head/w", w.shape, cpu_mesh(1, 2))
    assert lay.spec == ("tp", None) and lay.dim == 0
    rows = TPO.Shards(lay.split(w, 2), 0)
    torch.testing.assert_close(blocks.linear({"w": rows, "b": b}, x), x @ w + b, rtol=1e-5, atol=1e-5)

    logits = torch.from_numpy(rng.standard_normal((2, 7, 3, 32)).astype(np.float32)) * 4
    tgt = torch.from_numpy(rng.integers(0, 32, (2, 7, 3)))
    want = -torch.gather(torch.log_softmax(logits, -1), -1, tgt[..., None])[..., 0]
    for tp in (2, 4):
        got = TPO.nll(TPO.Shards(list(torch.chunk(logits, tp, dim=-1)), -1), tgt)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


class _Outputs(TorchDispatchMode):
    """Every tensor an op produces inside the mode."""

    def __init__(self):
        super().__init__()
        self.outs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.outs.extend(t for t in jax.tree_util.tree_leaves(out) if isinstance(t, torch.Tensor))
        return out


def test_no_op_of_the_step_makes_a_whole_sharded_leaf(setup):
    """Each sharded leaf's masters are 1/tp of it, and no tensor that an op
    of the step (forward, backward, optimizer) produces equals a whole
    sharded leaf: the products run on the shards, none gathers a weight."""
    state, opt = sharded(setup, 2, 2)
    whole = {lay.path: t for lay, t in zip(state.layouts, state.full_leaves().values())
             if lay.dim is not None}
    assert len(whole) > 30
    for path, t in whole.items():
        assert all(p.numel() * 2 == t.numel() for p in state.leaves[path]), path
    step = TP.make_train_step(state, opt)
    with _Outputs() as rec:
        step(torch_batch(make_batch()))
    by_shape = {}
    for out in rec.outs:
        by_shape.setdefault(tuple(out.shape), []).append(out)
    for path, t in whole.items():
        for out in by_shape.get(tuple(t.shape), []):
            assert not torch.equal(out.detach(), t), path


def test_cuda_mesh_without_a_card_raises(setup, monkeypatch):
    """No silent fallback: a mesh of CUDA devices without a card raises,
    and a mesh mixing the CPU with the card is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = fresh(setup)
    cuda_mesh = make_mesh(2, dp=1, tp=2, devices=[torch.device("cuda", 0)] * 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.shard_train_state(cuda_mesh, model, T.make_optimizer(model))
    mixed = make_mesh(2, dp=1, tp=2, devices=[torch.device("cuda", 0), torch.device("cpu")])
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        TP.shard_train_state(mixed, model, T.make_optimizer(model))


def test_bf16_model_is_refused(setup):
    model = fresh(setup).to(torch.bfloat16)
    with pytest.raises(ValueError, match="float32 only"):
        TP.shard_train_state(cpu_mesh(1, 2), model, T.make_optimizer(model))


def test_gather_back_serves_the_trained_weights(setup):
    """to_model writes the whole leaves into a SoproModel and drops its
    kernel-side caches."""
    state, opt = sharded(setup, 2, 2)
    TP.make_train_step(state, opt)(torch_batch(make_batch()))
    model = fresh(setup)
    model.nar.head_stacks()
    assert state.to_model(model) is model and model.nar._stacks is None
    full = state.full_leaves()
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), full[n]), n
