"""The UCN clustering at the 'cat' fusion's 128-d embedding, and the plain
twin of the connected-components kernel, against the JAX package.

The plain mean shift is width-generic: at d = 128 it gives the JAX package's
seeds, labels and climbed seeds. The numpy sweep (the plain twin of
``csrc/connected_components.cu``) gives the JAX package's labels, including
where a seed's component holds two labels equally often (the mode takes the
smaller).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from unseenobjectswithmeanshift_tpu.ops import mean_shift as jms
from unseenobjectswithmeanshift_torch.ops import mean_shift as ms
from unseenobjectswithmeanshift_torch.ops import mean_shift_kernels as msk

from test_torch_mean_shift import batch
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401


@pytest.mark.parametrize("first", [0, 500])
def test_mean_shift_smart_init_matches_jax_at_d128(first):
    X = batch(11, 1, 777, d=128, k=4)[0]
    want_l, want_i = jms.mean_shift_smart_init(jnp.asarray(X), num_seeds=12, max_iters=5,
                                               first_seed_idx=first)
    got_l, got_i = ms.mean_shift_smart_init(torch.from_numpy(X), num_seeds=12, max_iters=5,
                                            first_seed_idx=first)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    assert len(np.unique(got_l.numpy())) >= 2
    # the wrappers of the kernels take d = 128 and run the plain versions on the CPU
    fused_l, fused_i = msk.mean_shift_smart_init_fused(torch.from_numpy(X[None]), num_seeds=12,
                                                       max_iters=5, first_seed_idx=first)
    np.testing.assert_array_equal(fused_l[0].numpy(), np.asarray(want_l))
    Z = jms.seed_hill_climbing(jnp.asarray(X), jnp.asarray(X[np.asarray(want_i)]), 20.0, 5)
    got_z = ms.seed_hill_climbing(torch.from_numpy(X), torch.from_numpy(X[np.asarray(want_i)]),
                                  20.0, 5)
    # as test_seed_hill_climbing_matches_jax: fp32 sums in two orders, ~1e-7
    np.testing.assert_allclose(got_z.numpy(), np.asarray(Z), atol=2e-6)


def _tie_seeds(d=64):
    """Five seeds on a great circle at 0, 80, 40, 20 and 60 degrees: only
    neighbours 20 degrees apart lie within epsilon = 0.04 (cosine distance
    0.030; 40 degrees: 0.117). Seed 0 labels {0, 20} 0, seed 1 labels
    {80, 60} 1, then seed 2 (40) is unlabelled with one member of each
    label: the tie goes to 0. -> (Z [5, d], expected labels)."""
    u, v = np.linalg.qr(np.random.RandomState(5).randn(d, 2))[0].T
    a = np.radians([0.0, 80.0, 40.0, 20.0, 60.0])
    Z = (np.cos(a)[:, None] * u + np.sin(a)[:, None] * v).astype(np.float32)
    return Z, np.array([0, 1, 0, 0, 0], np.int32)


@pytest.mark.parametrize("d", [64, 128])
def test_connected_components_twin_matches_jax_with_label_ties(d):
    Z, expected = _tie_seeds(d)
    want = np.asarray(jms.connected_components(jnp.asarray(Z), 0.04))
    np.testing.assert_array_equal(want, expected)
    within = ms.seed_adjacency(torch.from_numpy(Z), 0.04)
    assert within.dtype == torch.uint8 and int(within.sum()) == 5 + 2 * 4
    np.testing.assert_array_equal(ms.connected_components_plain(within).numpy(), expected)
    np.testing.assert_array_equal(ms.connected_components(torch.from_numpy(Z), 0.04).numpy(),
                                  expected)
    # the larger label first: the tie still goes to the smaller one
    Zs = Z[[1, 0, 2, 3, 4]]
    np.testing.assert_array_equal(
        ms.connected_components_sweep(ms.seed_adjacency(torch.from_numpy(Zs[None]), 0.04))[0]
        .numpy(), np.asarray(jms.connected_components(jnp.asarray(Zs), 0.04)))
