"""The port's training losses against the JAX package's, on the CPU.

Point sampling, the host LSAP (against the JAX ``solve_lsap``, ties
included), the set criterion with deep supervision in its factored and its
materialized form and with pair compaction (every loss term within 1e-5
relative, on the JAX criterion's own draws), and the embedding loss (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import module_tmp_cleanup  # noqa: F401
from torch_train_cases import few_torch_threads, jax_draws  # noqa: F401
from unseenobjectswithmeanshift_tpu.losses.criterion import SetCriterion as JaxCriterion
from unseenobjectswithmeanshift_tpu.losses.embedding import embedding_loss as jax_embedding_loss
from unseenobjectswithmeanshift_tpu.losses.lsap import solve_lsap as jax_solve_lsap
from unseenobjectswithmeanshift_tpu.losses.point_sample import (
    get_uncertain_point_coords_with_randomness as jax_uncertain, point_sample as jax_point_sample,
    point_sample_factored as jax_point_sample_factored,
)
from unseenobjectswithmeanshift_torch.losses.criterion import SetCriterion
from unseenobjectswithmeanshift_torch.losses.embedding import embedding_loss
from unseenobjectswithmeanshift_torch.losses.lsap import solve_lsap
from unseenobjectswithmeanshift_torch.losses.point_sample import (
    get_uncertain_point_coords_with_randomness, point_sample, point_sample_factored,
)

t = torch.from_numpy


def test_point_sampling_matches_jax(rng):
    maps = rng.randn(3, 13, 17).astype(np.float32)
    pts = rng.rand(3, 50, 2).astype(np.float32)
    pts[0, :4] = [[0, 0], [1, 1], [0, 1], [1, 0]]                     # the corners
    np.testing.assert_allclose(point_sample(t(maps), t(pts)).numpy(),
                               np.asarray(jax_point_sample(maps, pts)), rtol=1e-6, atol=1e-6)
    me = rng.randn(2, 5, 8).astype(np.float32)
    mf = rng.randn(2, 13, 17, 8).astype(np.float32)
    want = np.stack([np.asarray(jax_point_sample_factored(me[b], mf[b], pts[b:b + 1]))
                     for b in range(2)])
    np.testing.assert_allclose(point_sample_factored(t(me), t(mf), t(pts[:2])).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    coords = np.asarray(jax.random.uniform(k1, (3, 90, 2)))
    rand = np.asarray(jax.random.uniform(k2, (3, 8, 2)))
    got = get_uncertain_point_coords_with_randomness(t(maps), 30, 3.0, 0.75, t(coords), t(rand))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_uncertain(key, maps, 30, 3.0, 0.75)))


@pytest.mark.parametrize("kind", ["random", "integer_ties"])
def test_lsap_equals_jax(rng, kind):
    for trial in range(24):
        Q, G = ((7, 4), (20, 9))[trial % 2]             # two shapes: two JAX compiles
        C = (rng.rand(Q, G) * 10 if kind == "random"
             else rng.randint(0, 3, size=(Q, G))).astype(np.float32)
        n = rng.randint(0, G + 1)
        want = np.asarray(jax_solve_lsap(jnp.asarray(C.T), jnp.int32(n)))
        np.testing.assert_array_equal(solve_lsap(C.T, n), want)


def _outputs(rng, B, Q, H, W, C, heads):
    """Random decoder outputs in both forms (factored and materialized)."""
    mf = rng.randn(B, H, W, C).astype(np.float32) * 0.5

    def head():
        me = rng.randn(B, Q, C).astype(np.float32) * 0.5
        return {"pred_logits": rng.randn(B, Q, 3).astype(np.float32), "mask_embed": me,
                "pred_masks": np.einsum("bqc,bhwc->bqhw", me, mf)}

    out = head()
    out["aux_outputs"] = [head() for _ in range(heads - 1)]
    out["mask_features"] = mf
    return out


def _targets(rng, B, G, H, W):
    masks = (rng.rand(B, G, H, W) > 0.6).astype(np.float32)
    valid = np.zeros((B, G), bool)
    valid[0, :3] = valid[1, :1] = True
    masks[~valid] = 0
    return rng.randint(0, 2, (B, G)).astype(np.int32), masks, valid


@pytest.mark.parametrize("form,budget", [("factored", None), ("materialized", None),
                                         ("factored", 4)])
def test_criterion_matches_jax(rng, form, budget):
    B, Q, G, H, W, C, heads, P = 2, 6, 5, 16, 20, 8, 3, 40
    out = _outputs(rng, B, Q, H, W, C, heads)
    if form == "materialized":
        for h in [out] + out["aux_outputs"]:
            del h["mask_embed"]
        del out["mask_features"]
    labels, masks, valid = _targets(rng, B, G, H, W)
    key = jax.random.PRNGKey(11)
    jcrit = jax.jit(lambda *a: JaxCriterion(num_points=P)(*a, pair_budget=budget))
    jtotal, jlosses = jcrit(key, jax.tree.map(jnp.asarray, out), jnp.asarray(labels),
                            jnp.asarray(masks), jnp.asarray(valid))
    draws = jax_draws(key, heads, B, B * G, P)
    total, losses = SetCriterion(num_points=P)(jax.tree.map(t, out), t(labels), t(masks),
                                                t(valid), draws, pair_budget=budget)
    assert set(losses) == set(jlosses) and len(losses) == 3 * heads
    for name in losses:
        np.testing.assert_allclose(float(losses[name]), float(jlosses[name]), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)


def test_embedding_loss_matches_jax(rng):
    x = rng.randn(2, 12, 14, 6).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    labels = rng.randint(-1, 4, (2, 12, 14)).astype(np.int32)       # slot 4 stays empty
    want = jax_embedding_loss(jnp.asarray(x), jnp.asarray(labels), k_max=6)
    got = embedding_loss(t(x), t(labels), k_max=6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=1e-8)
