"""The port's optimizer against the JAX package's optax chain.

Three steps on identical gradients (random, in the port's layout, carried to
the JAX layout by weights.to_jax_variables), at a norm above the clip (0.01)
for two steps and below it for one, on the tiny MSMFormer's parameters (one
SEGNET tower):
clip_by_global_norm -> Adam -> weight decay masked off norms and embeddings
-> -lr -> the backbone multiplier (JAX ``make_optimizer``) against one
``torch.optim.AdamW`` with per-group lr and weight decay. Every parameter
within 1e-6 after each step. Also the warm-up schedule.
"""

import jax
import numpy as np
import optax
import torch

from torch_threads import module_tmp_cleanup  # noqa: F401
from torch_train_cases import few_torch_threads, tiny_configs, tree_items  # noqa: F401
from unseenobjectswithmeanshift_tpu.train.trainer import make_optimizer as jax_make_optimizer
from unseenobjectswithmeanshift_torch.train.trainer import (
    clip_by_global_norm_, learning_rate, make_optimizer, new_model,
)
from unseenobjectswithmeanshift_torch.weights import to_jax_variables


def test_optimizer_matches_optax_chain():
    jc, pc = tiny_configs("COLOR")                   # one SEGNET tower: half the leaves
    model = new_model(pc, seed=0, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    opt = make_optimizer(model, pc)
    tx = jax_make_optimizer(jc)
    # copies: the tree holds views of the parameters, and JAX on the CPU may
    # read a numpy argument in place after its call returned, so opt.step()
    # below would race the JAX step (seen as a doubled update under load)
    jparams = jax.tree.map(np.array, to_jax_variables(
        {n: p.detach() for n, p in params.items()})["params"])
    state = tx.init(jparams)

    @jax.jit
    def jax_step(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    gen = torch.Generator().manual_seed(0)
    for step, norm in enumerate((3.0, 0.5, 0.004)):
        g = {n: torch.randn(params[n].shape, generator=gen) for n in names}
        total = float(torch.linalg.vector_norm(torch.stack([x.norm() for x in g.values()])))
        g = {n: x * np.float32(norm / total) for n, x in g.items()}
        jg = to_jax_variables(g)["params"]
        jparams, state = jax_step(jg, state, jparams)

        for n, p in params.items():
            p.grad = g[n].clone()
        grads = [p.grad for p in params.values()]
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        clip_by_global_norm_(grads, gnorm, float(gnorm), pc.solver.clip_gradients)
        for group in opt.param_groups:
            group["lr"] = learning_rate(pc, step) * group["multiplier"]
        opt.step()

        got = tree_items(to_jax_variables({n: p.detach() for n, p in params.items()})["params"])
        want = tree_items(jax.tree.map(np.asarray, jparams))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=str(k))


def test_warmup_schedule():
    _, pc = tiny_configs()
    assert [learning_rate(pc, s) for s in (0, 5, 10**6)] == [pc.solver.base_lr] * 3
    pc.solver.warmup_factor, pc.solver.warmup_iters = 0.1, 10
    want = optax.linear_schedule(init_value=pc.solver.base_lr * 0.1, end_value=pc.solver.base_lr,
                                 transition_steps=10)
    for s in (0, 3, 10, 25):
        np.testing.assert_allclose(learning_rate(pc, s), float(want(s)), rtol=1e-6)
