"""The port's mean-shift clustering against the JAX package on the CPU.

The plain functions of ``ops/mean_shift.py`` against ``ops/mean_shift.py`` of
the JAX package (the scan formulation it runs on the CPU), and the kernel
wrappers of ``ops/mean_shift_kernels.py`` on CPU tensors (their plain route)
against the Pallas kernels in interpret mode, which is how the JAX package
runs them on the CPU. Inputs follow ``tests/test_pallas_mean_shift.py``:
unit vectors around a few directions, here with duplicated rows (exact ties)
and N a multiple of no block size. Indices and labels must be equal; seeds
within 2e-6, as the JAX package's own test holds its kernel.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from unseenobjectswithmeanshift_tpu.ops import mean_shift as jms
from unseenobjectswithmeanshift_tpu.ops.pallas_mean_shift import (
    fps_seeds_pallas, mean_shift_seeds_pallas, mean_shift_smart_init_fps as jax_init_fps,
    mean_shift_smart_init_pallas as jax_init_fused,
)
from unseenobjectswithmeanshift_torch.ops import mean_shift as ms
from unseenobjectswithmeanshift_torch.ops import mean_shift_kernels as msk
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401


def clustered_points(rng, n=600, d=64, k=5, dups=30):
    """Unit vectors around k random directions; `dups` rows are copies of
    other rows, so that the farthest-point chain meets exact ties."""
    centers = rng.randn(k, d)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    X = centers[rng.randint(0, k, n)] + 0.12 * rng.randn(n, d)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    X = X.astype(np.float32)
    X[rng.randint(0, n, dups)] = X[rng.randint(0, n, dups)]
    return X


def batch(seed, B, n, d=64, k=5):
    rng = np.random.RandomState(seed)
    return np.stack([clustered_points(rng, n, d, k) for _ in range(B)])


@pytest.mark.parametrize("n,d,first", [(600, 16, 0), (777, 64, 5), (1001, 64, 999)])
def test_select_smart_seeds_matches_jax(n, d, first):
    X = batch(n, 1, n, d)[0]
    want_s, want_i = jms.select_smart_seeds(jnp.asarray(X), 12, first)
    got_s, got_i = ms.select_smart_seeds(torch.from_numpy(X), 12, first)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))   # copied rows


@pytest.mark.parametrize("n,iters", [(777, 5), (1001, 10)])
def test_seed_hill_climbing_matches_jax(n, iters):
    X = batch(n + 1, 1, n)[0]
    Z = X[np.random.RandomState(n).choice(n, 12, replace=False)]
    want = jms.seed_hill_climbing(jnp.asarray(X), jnp.asarray(Z), 20.0, iters)
    got = ms.seed_hill_climbing(torch.from_numpy(X), torch.from_numpy(Z), 20.0, iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def _chain_seeds(rng, S=14, d=64):
    """Seeds on one great circle at random angles: neighbours within epsilon
    chain into components whose labels merge by the mode rule."""
    u, v = np.linalg.qr(rng.randn(d, 2))[0].T
    a = np.sort(rng.uniform(0, 2.0, S))
    rng.shuffle(a)
    return (np.cos(a)[:, None] * u + np.sin(a)[:, None] * v).astype(np.float32)


@pytest.mark.parametrize("kind", ["climbed", "chain", "duplicates"])
def test_connected_components_matches_jax(kind):
    rng = np.random.RandomState(3)
    if kind == "climbed":
        X = clustered_points(rng, 500)
        Z = np.array(jms.seed_hill_climbing(jnp.asarray(X), jnp.asarray(X[:20]), 20.0, 10))
    elif kind == "chain":
        Z = _chain_seeds(rng)
    else:
        Z = np.repeat(_chain_seeds(rng, 6), 3, axis=0)
    want = np.asarray(jms.connected_components(jnp.asarray(Z), 0.04))
    got = ms.connected_components(torch.from_numpy(Z), 0.04)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) >= 2
    batched = ms.connected_components(torch.from_numpy(np.stack([Z, Z[::-1].copy()])), 0.04)
    np.testing.assert_array_equal(batched[0].numpy(), want)
    np.testing.assert_array_equal(
        batched[1].numpy(), np.asarray(jms.connected_components(jnp.asarray(Z[::-1]), 0.04)))


@pytest.mark.parametrize("n,S,first", [(777, 12, 0), (1001, 16, 321)])
def test_mean_shift_smart_init_matches_jax(n, S, first):
    X = batch(n + 2, 1, n, k=4)[0]
    want_l, want_i = jms.mean_shift_smart_init(jnp.asarray(X), num_seeds=S, max_iters=5,
                                               first_seed_idx=first)
    got_l, got_i = ms.mean_shift_smart_init(torch.from_numpy(X), num_seeds=S, max_iters=5,
                                            first_seed_idx=first)
    assert got_l.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    assert len(np.unique(got_l.numpy())) >= 2


def test_clustering_features_matches_jax():
    X = batch(5, 2, 24 * 30, k=4)
    feats = X.reshape(2, 24, 30, 64)
    want_l, want_i = jms.clustering_features(jnp.asarray(feats), num_seeds=10, max_iters=5,
                                             first_seed_idx=7)
    got_l, got_i = ms.clustering_features(torch.from_numpy(feats), num_seeds=10, max_iters=5,
                                          first_seed_idx=7)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_fps_seeds_wrapper_matches_pallas_interpret():
    X = batch(11, 2, 1001)
    first = np.array([3, 777], np.int32)
    want_s, want_i = fps_seeds_pallas(jnp.asarray(X), jnp.asarray(first), num_seeds=12,
                                      interpret=True)
    before = msk.fps_seeds.launches
    got_s, got_i = msk.fps_seeds(torch.from_numpy(X), torch.from_numpy(first), num_seeds=12)
    assert msk.fps_seeds.launches == before        # CPU: the plain version
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=2e-6)


def test_mean_shift_seeds_wrapper_matches_pallas_interpret():
    X = batch(12, 2, 1001)
    first = np.array([3, 777], np.int32)
    want_s, want_i = mean_shift_seeds_pallas(jnp.asarray(X), jnp.asarray(first), kappa=20.0,
                                             num_seeds=12, max_iters=5, chunk=128,
                                             interpret=True)
    before = (msk.fps_seeds.launches, msk.mean_shift_seeds.launches)
    got_s, got_i = msk.mean_shift_seeds(torch.from_numpy(X), torch.from_numpy(first),
                                        kappa=20.0, num_seeds=12, max_iters=5)
    assert (msk.fps_seeds.launches, msk.mean_shift_seeds.launches) == before
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=2e-6)


@pytest.mark.parametrize("route", ["fps", "fused"])
def test_smart_init_routes_match_pallas_interpret(route):
    X = batch(13, 2, 777, k=4)
    jax_fn, port_fn = {"fps": (jax_init_fps, msk.mean_shift_smart_init_fps),
                       "fused": (jax_init_fused, msk.mean_shift_smart_init_fused)}[route]
    kw = dict(kappa=20.0, num_seeds=10, max_iters=5, epsilon=0.04, first_seed_idx=4)
    extra = {"chunk": 128} if route == "fused" else {}
    want_l, want_i = jax_fn(jnp.asarray(X), interpret=True, **kw, **extra)
    got_l, got_i = port_fn(torch.from_numpy(X), **kw)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    assert got_l.shape == (2, 777) and got_l.dtype == torch.int32


F1_N = 50


@pytest.mark.parametrize("first", [-1, -2, F1_N, F1_N + 20, -F1_N - 20])
@pytest.mark.parametrize("fn", ["select_smart_seeds", "mean_shift_smart_init", "fps_seeds"])
def test_first_seed_idx_outside_the_rows_matches_jax(fn, first):
    # the JAX package reads X[first] with jnp indexing (-N <= i < 0 wraps,
    # beyond the ends clamps) and returns first as given in indices[0]
    X = np.random.RandomState(3).randn(F1_N, 8).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    if fn == "mean_shift_smart_init":
        kw = dict(kappa=20.0, num_seeds=6, max_iters=3, epsilon=0.04, first_seed_idx=first)
        want_l, want_i = jms.mean_shift_smart_init(jnp.asarray(X), **kw)
        got_l, got_i = ms.mean_shift_smart_init(torch.from_numpy(X), **kw)
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    else:
        want_s, want_i = jms.select_smart_seeds(jnp.asarray(X), 6, first)
        if fn == "fps_seeds":
            got_s, got_i = msk.fps_seeds(torch.from_numpy(X)[None], first, 6)
            got_s, got_i = got_s[0], got_i[0]
        else:
            got_s, got_i = ms.select_smart_seeds(torch.from_numpy(X), 6, first)
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))   # copied rows
    assert got_i.dtype == torch.int32 and int(got_i[0]) == first
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
