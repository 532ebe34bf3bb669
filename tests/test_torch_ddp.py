"""Data-parallel training (`sopro_tpu_torch.parallel`) on the CPU: two gloo
processes with a `file://` rendezvous, each holding two rows of a four-row
batch whose ranks hold different numbers of valid frames (19 and 13). The
loss, the gradients and the parameters after one step equal one process
stepping on the whole batch: the loss terms are divided by the counts summed
over the ranks (the JAX package's global masked mean), not averaged per
rank.

Tolerances: the loss within 1e-6 relative, a leaf's gradient within 1e-6 of
its largest entry plus 1e-9 (the ranks' partial sums add in another order;
a leaf whose gradient cancels to ~1e-7 keeps ~1e-12 of rounding), the
parameters after one AdamW step (lr 1e-3) within 1e-6.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sopro_tpu_torch import parallel as P
from sopro_tpu_torch import train as T
from sopro_tpu_torch import weights as W
from sopro_tpu_torch.config import SoproTTSConfig

from tests.test_torch_cuda import TEXT_VOCAB, TRAIN_CFG, make_batch, torch_batch

torch.set_num_threads(1)

WORLD = 2
SEED = 7
LR = 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model():
    cfg = SoproTTSConfig(**TRAIN_CFG)
    tree = W.init_sopro_params(SEED, cfg, TEXT_VOCAB)
    W.fill_zero_inits(tree, None, SEED + 1)
    return W.sopro_params_from_jax(tree, cfg, "cpu")


def _state(model, metrics):
    return {"metrics": {k: v.detach().clone() for k, v in metrics.items()},
            "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()},
            "params": {n: p.detach().clone() for n, p in model.named_parameters()}}


def rank_main(rank: int, init_file: str, out: str) -> None:
    """One rank: join the group, step on its rows, save what it saw."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dev = P.init_process_group(rank, WORLD, f"file://{init_file}", device="cpu")
    try:
        model = _model()
        step = P.make_train_step(model, T.make_optimizer(model, lr=LR))
        metrics = step(P.shard_batch(torch_batch(make_batch()), rank, WORLD).to(dev))
        torch.save(_state(model, metrics), out)
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_equal_the_full_batch(tmp_path):
    nb = make_batch()
    counts = [int(nb["frame_mask"][r * 2:(r + 1) * 2].sum()) for r in range(WORLD)]
    assert counts[0] != counts[1]

    init_file = str(tmp_path / "rendezvous")
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c",
             f"from tests.test_torch_ddp import rank_main; rank_main({r}, {init_file!r}, {outs[r]!r})"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(WORLD)
    ]
    for p in procs:
        log, _ = p.communicate(timeout=240)
        assert p.returncode == 0, log[-3000:]

    model = _model()
    opt = T.make_optimizer(model, lr=LR)
    opt.zero_grad(set_to_none=False)
    loss, metrics = T.loss_fn(model, torch_batch(nb))
    loss.backward()
    T.fill_missing_grads(opt)
    opt.step()
    want = _state(model, metrics)

    for out in outs:
        got = torch.load(out, weights_only=True)
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(float(got["metrics"][k]), float(v), rtol=1e-6, err_msg=k)
        for n, g in want["grads"].items():
            peak = float(g.abs().max())
            err = float((got["grads"][n] - g).abs().max())
            assert err <= 1e-6 * peak + 1e-9, (n, err, peak)
        for n, p in want["params"].items():
            np.testing.assert_allclose(got["params"][n].numpy(), p.numpy(), rtol=0, atol=1e-6,
                                       err_msg=n)


def test_shard_batch_takes_contiguous_rows():
    b = torch_batch(make_batch())
    parts = [P.shard_batch(b, r, 2) for r in range(2)]
    for field in range(len(b)):
        assert torch.equal(torch.cat([p[field] for p in parts]), b[field])
    with pytest.raises(ValueError):
        P.shard_batch(b, 0, 3)
