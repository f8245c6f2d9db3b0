"""One MSMFormer train step of the port against the JAX package's
``Trainer.train_step``, at the tiny case of tests/torch_train_cases.py (full
ResNet34-8s towers, the embedding loss on), gated behind
UOMS_TRAIN_PARITY=1: the JAX train step's compile takes ~75 s on a cold
cache, too much for Tier-1, which holds the pieces instead
(tests/test_torch_train_model.py, _losses.py, _attention.py):

    UOMS_TRAIN_PARITY=1 python -m pytest -q tests/test_torch_train_step.py

Same weights (the JAX init carried over by weights.from_jax_variables), same
batch, the JAX criterion's own draws (tests/torch_train_cases.jax_draws).
JAX's train_step, with its optimizer replaced by a scale of 2^20, returns
params + 2^20 g, from which the test reads the raw gradient g of every leaf
(train_step does not return it; the loss terms and the BatchNorm running
statistics come from the same call). The port's gradients are read back in
the JAX layout by weights.to_jax_variables.

Tolerances: loss terms 1e-5 relative; every gradient leaf within 1e-4 of
the model's largest gradient entry; running statistics within 5e-6 of each
leaf's largest entry. On
this case fp32 rounding alone moves a leaf by more than 1e-4 of its own
scale (the last self-attention's q kernel, kappa 30 on 8-d heads: JAX's
fp32 gradient lies 1.4e-4 of the leaf from the port's fp64 one, and the
port's fp32 one moves by up to 4e-4 between runs with the threads' summation
order), and JAX's fp32 running variance lies 2.5e-6 of its value (1.46,
E[x^2] - E[x]^2) from the port's fp64 one; the decoder alone, with decisive
masks, holds 1e-4 of each leaf (tests/test_torch_train_model.py).
"""

import os

import pytest
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from torch_threads import module_tmp_cleanup  # noqa: F401
from torch_train_cases import (  # noqa: F401 (few_torch_threads: autouse)
    B, G, H, W, few_torch_threads, jax_draws, scaled_diff, tiny_batch, tiny_configs, to_torch,
    tree_items,
)
from unseenobjectswithmeanshift_tpu.train.trainer import Trainer as JaxTrainer
from unseenobjectswithmeanshift_torch.models.meta_arch import build_model
from unseenobjectswithmeanshift_torch.train.trainer import Trainer
from unseenobjectswithmeanshift_torch.weights import from_jax_variables, to_jax_variables

GRAD_SCALE = 2.0 ** 20

pytestmark = pytest.mark.skipif(
    os.environ.get("UOMS_TRAIN_PARITY") != "1",
    reason="the JAX train step's compile is heavy; set UOMS_TRAIN_PARITY=1")


def test_train_step_matches_jax():
    jc, pc = tiny_configs()
    jc.loss.use_embedding_loss = pc.loss.use_embedding_loss = True
    jtr = JaxTrainer(jc)
    state = jtr.init_state(jax.random.PRNGKey(0), (H, W), batch_size=B)
    jtr.tx = optax.scale(GRAD_SCALE)
    state = state.replace(opt_state=jtr.tx.init(state.params))
    batch = tiny_batch()
    key = jax.random.PRNGKey(3)
    new_state, metrics = jax.jit(jtr.train_step)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, key)

    torch.manual_seed(0)
    model = build_model(pc)
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    model.load_state_dict(from_jax_variables(variables))
    tr = Trainer(pc, device="cpu", model=model)
    draws = jax_draws(key, 1 + pc.decoder.dec_layers, B, B * G, pc.loss.train_num_points)
    total, losses = tr.gradients(to_torch(batch), draws)

    for name, value in losses.items():
        np.testing.assert_allclose(float(value.detach()), float(metrics[name]), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    np.testing.assert_allclose(float(total.detach()), float(metrics["total_loss"]), rtol=1e-5)

    old = tree_items(variables["params"])
    new = tree_items(jax.tree.map(np.asarray, new_state.params))
    got = tree_items(to_jax_variables(
        {n: p.grad for n, p in model.named_parameters()})["params"])
    assert set(got) == set(old)
    want = {k: (new[k] - old[k]) / GRAD_SCALE for k in old}
    scale = max(float(np.abs(g).max()) for g in want.values())
    worst = max((float(np.abs(got[k] - want[k]).max()) / scale, k) for k in old)
    assert worst[0] <= 1e-4, worst

    want_stats = tree_items(jax.tree.map(np.asarray, new_state.batch_stats))
    got_stats = tree_items(to_jax_variables(model.state_dict())["batch_stats"])
    assert set(got_stats) == set(want_stats)
    worst = max((scaled_diff(got_stats[k], want_stats[k]), k) for k in want_stats)
    assert worst[0] <= 5e-6, worst
