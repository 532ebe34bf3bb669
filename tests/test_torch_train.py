"""The port's training layer against the JAX package on the CPU: the
teacher-forced AR forward and the NAR stage logits, the loss, the gradients
and one AdamW step against `sopro_tpu.train` / `optax.adamw`; the loss
falling; a resume bit-identical to straight steps; and serving after steps
from fresh caches (the NAR head stacks and K1/K5's weight views are dropped
by `weights_changed`).

Small configuration of tests/test_parallel.py; a batch of unequal row
lengths with a full-length row (no EOS target), partial text and reference
masks. Weights from the JAX package's init with the zero-initialised leaves
filled. Tolerances: the loss within 1e-5 relative; a leaf's gradient within
1e-4 of its largest entry (plus 1e-9: the frameworks sum in other orders);
one AdamW step within 1e-6 of the parameters (lr 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sopro_tpu import train as JT
from sopro_tpu.config import SoproTTSConfig as JCfg
from sopro_tpu.models import generator as JG
from sopro_tpu.models import nar as JN
from sopro_tpu.models import sopro as JM
from sopro_tpu.models.sopro import init_sopro_model
from sopro_tpu.ops.embeddings import cb_sum_embed_subset as j_cb_sum

from sopro_tpu_torch import train as T
from sopro_tpu_torch import weights as W
from sopro_tpu_torch.config import SoproTTSConfig
from sopro_tpu_torch.models import generator as TG
from sopro_tpu_torch.models import nar as TN
from sopro_tpu_torch.models import sopro as TM
from sopro_tpu_torch.models.sopro import _SUBMODULES as SUBMODULES, SoproModel as SoproModelT
from sopro_tpu_torch.models.base import tree_map
from sopro_tpu_torch.ops.embeddings import cb_sum_embed_subset

from tests.test_torch_cuda import TEXT_VOCAB, TRAIN_CFG, make_batch, torch_batch
from tests.test_torch_ops import STACK_TOL, close, t2n

torch.set_num_threads(1)

LR = 1e-3
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
ADAM_ATOL = 1e-6
ZERO_LEAF = ("nar", "mix", "C")  # its gradient is dropped in the AdamW test


def jax_batch(nb):
    return JT.TrainBatch(**{k: jnp.asarray(v) for k, v in nb.items()})


def make_tree(seed=0):
    jcfg = JCfg(**TRAIN_CFG)
    tree = jax.tree.map(np.array, init_sopro_model(jax.random.PRNGKey(seed), jcfg, TEXT_VOCAB))
    W.fill_zero_inits(tree, None, seed + 100)
    return tree, jcfg, SoproTTSConfig(**TRAIN_CFG)


def grad_tree(model):
    """The model's gradients in the parameter tree's layout (numpy)."""
    tree = dict(model.shared.p, **{n: getattr(model, n).p for n in SUBMODULES})
    return tree_map(lambda t: t.grad.detach().numpy().copy(), tree)


def tree_leaves(tree):
    """The leaves of a parameter tree in its flattening order (the model's
    trees give its Parameters)."""
    if isinstance(tree, SoproModelT):
        tree = dict(tree.shared.p, **{n: getattr(tree, n).p for n in SUBMODULES})
    return jax.tree_util.tree_leaves(tree)


def leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}


@pytest.fixture(scope="module")
def setup():
    """The weights, the batch, and the JAX loss, metrics and gradients
    (computed once)."""
    tree, jcfg, tcfg = make_tree()
    nb = make_batch()
    jp = jax.tree.map(jnp.asarray, tree)
    (jloss, jmetrics), jgrads = jax.jit(
        jax.value_and_grad(lambda p, b: JT.loss_fn(p, jcfg, b), has_aux=True)
    )(jp, jax_batch(nb))
    return dict(tree=tree, jcfg=jcfg, tcfg=tcfg, nb=nb, jp=jp, jloss=float(jloss),
                jmetrics={k: float(v) for k, v in jmetrics.items()},
                jgrads=jax.tree.map(np.asarray, jgrads))


def fresh_model(setup):
    return W.sopro_params_from_jax(setup["tree"], setup["tcfg"], "cpu")


def test_ar_forward_and_nar_stage_logits_match_jax(setup):
    jp, jcfg, nb = setup["jp"], setup["jcfg"], setup["nb"]
    model = fresh_model(setup)
    b = torch_batch(nb)
    s = nb["frames"].shape[1]
    x = np.random.default_rng(1).standard_normal((4, s, 64)).astype(np.float32) * 0.5
    prev = [0, 1, 2]

    @jax.jit
    def jax_side(jp, jb):
        jref = JM.prepare_reference(jp, jcfg, jb.ref_tokens, mask=jb.ref_mask)
        jprep = JM.prepare_conditioning(jp, jcfg, jb.text_ids, jb.text_mask, jref,
                                        max_frames=s - 1, style_strength=1.0)
        ar = JG.ar_forward(jp["ar"], jcfg, x, jprep["txt_seq"], jb.text_mask,
                           frame_mask=jb.frame_mask)
        jprev = j_cb_sum(jp["cb_embed"], JM.cb_spec(jcfg), jb.frames[..., jnp.asarray(prev)],
                         prev, cb_weights=jp["nar_prev_cb_weights"])
        return ar, [JN.nar_forward_stage(jp["nar"], jcfg, "C", jprep["cond_ar"], jprev,
                                         mask=jb.frame_mask, head_tail=tail)
                    for tail in (None, 5)]

    want_ar, want_nar = jax_side(jp, jax_batch(nb))
    with torch.no_grad():
        tref = TM.prepare_reference(model, b.ref_tokens, mask=b.ref_mask)
        tprep = TM.prepare_conditioning(model, b.text_ids, b.text_mask, tref,
                                        max_frames=s - 1, style_strength=1.0)
        got = TG.ar_forward(model.ar.p, setup["tcfg"], torch.from_numpy(x), tprep["txt_seq"],
                            b.text_mask, frame_mask=b.frame_mask)
        assert got.shape == (4, s, jcfg.codebook_size + 1)
        close(t2n(got), want_ar, STACK_TOL)
        tprev = cb_sum_embed_subset(model.shared.p["cb_embed"], TM.cb_spec(setup["tcfg"]),
                                    b.frames[..., prev], prev,
                                    cb_weights=model.shared.p["nar_prev_cb_weights"])
        for tail, want in zip((None, 5), want_nar):
            got = TN.nar_forward_stage(model.nar.p, setup["tcfg"], "C", tprep["cond_ar"], tprev,
                                       mask=b.frame_mask, head_tail=tail)
            assert got.shape == (4, tail or s, 2, jcfg.codebook_size)
            close(t2n(got), want, STACK_TOL)


def test_loss_matches_jax(setup):
    model = fresh_model(setup)
    loss, metrics = T.loss_fn(model, torch_batch(setup["nb"]))
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v.detach()), setup["jmetrics"][k], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss.detach()), setup["jloss"], rtol=LOSS_RTOL)


def test_gradients_match_jax(setup):
    model = fresh_model(setup)
    loss, _ = T.loss_fn(model, torch_batch(setup["nb"]))
    loss.backward()
    got, want = leaves(grad_tree(model)), leaves(setup["jgrads"])
    assert got.keys() == want.keys() and len(got) == sum(1 for _ in model.parameters())
    for k in want:
        peak = float(np.abs(want[k]).max())
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= GRAD_TOL * peak + 1e-9, (k, err, peak)
    # every leaf of the Sopro model trains; the Mimi codec's do not
    assert all(p.requires_grad for p in model.parameters())


def test_adamw_step_matches_optax(setup):
    """One step from the same (JAX's) gradients, with ZERO_LEAF's dropped:
    optax decays that leaf and so must the port (its `.grad` is None, as
    for a leaf outside the loss's graph)."""
    jgrads = jax.tree.map(np.copy, setup["jgrads"])
    node = jgrads
    for k in ZERO_LEAF[:-1]:
        node = node[k]
    node[ZERO_LEAF[-1]] = np.zeros_like(node[ZERO_LEAF[-1]])
    opt = optax.adamw(LR, weight_decay=0.01)
    jp = setup["jp"]

    @jax.jit
    def adamw_step(g, p):
        updates, _ = opt.update(g, opt.init(p), p)
        return optax.apply_updates(p, updates)

    want = leaves(jax.tree.map(np.asarray, adamw_step(jax.tree.map(jnp.asarray, jgrads), jp)))

    model = fresh_model(setup)
    optimizer = T.make_optimizer(model, lr=LR, weight_decay=0.01)
    for p, g in zip(tree_leaves(model), tree_leaves(jgrads)):
        p.grad = torch.from_numpy(np.array(g)).reshape(p.shape)  # JAX's () gates are [1] here
    leaf = getattr(model.nar, "__".join(ZERO_LEAF[1:]))
    leaf.grad = None
    before = leaf.detach().clone()
    T.fill_missing_grads(optimizer)
    optimizer.step()
    got = leaves(W.sopro_tree(model))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ADAM_ATOL, err_msg=k)
    # the dropped leaf moved by the decay alone, as optax moves it
    np.testing.assert_allclose(t2n(leaf), t2n(before) * (1 - LR * 0.01), rtol=1e-7)


def test_five_steps_lower_the_loss(setup):
    model = fresh_model(setup)
    step = T.make_train_step(model, T.make_optimizer(model, lr=LR))
    batch = torch_batch(setup["nb"])
    losses = [float(step(batch)["loss"]) for _ in range(5)]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses


def test_resume_is_bit_identical(setup, tmp_path):
    batch = torch_batch(setup["nb"])
    straight = fresh_model(setup)
    opt = T.make_optimizer(straight, lr=LR)
    step = T.make_train_step(straight, opt)
    for _ in range(2):
        step(batch)
    path = str(tmp_path / "train.pt")
    T.save_train_checkpoint(path, straight, opt, step=2)
    want = step(batch)

    resumed = W.sopro_params_from_jax(make_tree(seed=3)[0], setup["tcfg"], "cpu")  # other weights
    opt2 = T.make_optimizer(resumed, lr=LR)
    assert T.restore_train_checkpoint(path, resumed, opt2) == 2
    got = T.make_train_step(resumed, opt2)(batch)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for (name, a), (_, b) in zip(straight.named_parameters(), resumed.named_parameters()):
        assert torch.equal(a, b), name
    sa, sb = opt.state_dict()["state"], opt2.state_dict()["state"]
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


def test_serving_after_steps_uses_the_new_weights(setup):
    """Synthesize before training (builds the NAR head stacks), take two
    steps, synthesize again: it equals a model rebuilt from the trained
    weights, and so do the head stacks."""
    from sopro_tpu_torch.codec.mimi_config import MimiConfig
    from sopro_tpu_torch.engine import Engine
    from sopro_tpu_torch.tokenizer import SimpleCharTokenizer
    from sopro_tpu_torch.tts import SoproTTS

    from tests.test_torch_cuda import SMALL_MIMI

    tcfg, mcfg = setup["tcfg"], MimiConfig(**SMALL_MIMI)
    mtree = W.init_mimi_params(1, mcfg)

    def tts_of(model):
        return SoproTTS(Engine(model, W.mimi_params_from_jax(mtree, mcfg, "cpu")), tcfg,
                        SimpleCharTokenizer())

    model = fresh_model(setup)
    tts = tts_of(model)
    ref = np.random.default_rng(2).integers(0, 32, (10, 8)).astype(np.int32)
    kw = dict(ref_tokens_tq=ref, max_frames=20, seed=3, fused=True)
    before = tts.synthesize("a short text", **kw)
    stacks_before = {s: v[1].clone() for s, v in model.nar.head_stacks().items()}
    step = T.make_train_step(model, T.make_optimizer(model, lr=LR))
    for _ in range(2):
        step(torch_batch(setup["nb"]))
    after = tts.synthesize("a short text", **kw)

    rebuilt = W.sopro_params_from_jax(W.sopro_tree(model), tcfg, "cpu")
    np.testing.assert_array_equal(after, tts_of(rebuilt).synthesize("a short text", **kw))
    for s, (hid, w, b, _) in rebuilt.nar.head_stacks().items():
        got = model.nar.head_stacks()[s]
        assert torch.equal(got[0], hid) and torch.equal(got[1], w) and torch.equal(got[2], b), s
        assert not torch.equal(got[1], stacks_before[s]), s  # the steps moved the heads
    assert before.shape[0] == after.shape[0] == 1
