"""The UCN clustering at the sizes the JAX package serves, on the CPU.

- FPS in groups of whole images: the persistent FPS kernel holds the running
  distance of every row of its launch in shared memory, so at B=8 frames x
  20 crops (160 x 224^2 rows) or B >= 25 whole frames one launch does not
  fit; ``fps_plan`` cuts the images into as few and as even groups as fit
  (at the H100's 132 SMs and 232,448 bytes), one launch each. The JAX
  package's check is per image (its ``pipeline/ucn.py:55``). The seeds are
  the same bits in groups (each chain is one image's), which
  tests/test_torch_cuda.py and chip_smoke.py check on the card.
- More than 128 seeds: the plain clustering at num_seeds = 200 (either
  seeding route, connected components) against the JAX package's; the
  kernels' own limits (1024 seeds) raise a ValueError that names them.
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

SMS, SMEM_PER_BLOCK = 132, 232_448


@pytest.mark.parametrize("B,N,groups", [(160, 50_176, 2), (25, 307_200, 2),
                                        (140, 50_176, 1), (24, 307_200, 1),
                                        (400, 50_176, 3)])
def test_fps_plan_groups_whole_images(B, N, groups):
    p = msk.fps_plan(B, N, SMS, SMEM_PER_BLOCK)
    g = p["groups"]
    assert len(g) == groups
    assert g[0][0] == 0 and g[-1][1] == B
    assert all(a[1] == b[0] for a, b in zip(g, g[1:]))          # consecutive, whole images
    sizes = [e - b for b, e in g]
    assert max(sizes) - min(sizes) <= 1                           # as even as they fit
    totals = {"l2_held_rows": 0, "streamed_rows": 0}
    for b, e in g:
        q = msk.fps_plan(e - b, N, SMS, SMEM_PER_BLOCK)
        assert q["groups"] == [(0, e - b)]                        # each group is one launch
        assert q["smem_bytes"] <= SMEM_PER_BLOCK and q["grid"] <= SMS
        for k in totals:
            totals[k] += q[k]
    assert {k: p[k] for k in totals} == totals
    if groups > 1:   # with one group fewer, a group would not fit one launch
        fewer = -(-B // (groups - 1))
        assert len(msk.fps_plan(fewer, N, SMS, SMEM_PER_BLOCK)["groups"]) > 1


@pytest.mark.parametrize("route", ["fps", "fused"])
def test_smart_init_at_200_seeds_matches_jax(route):
    X = batch(11, 1, 1500, k=6)[0]
    fn = msk.mean_shift_smart_init_fps if route == "fps" else msk.mean_shift_smart_init_fused
    got_l, got_i = fn(torch.from_numpy(X)[None], num_seeds=200, max_iters=5, first_seed_idx=3)
    want_l, want_i = jms.mean_shift_smart_init(jnp.asarray(X), num_seeds=200, max_iters=5,
                                               first_seed_idx=3)
    np.testing.assert_array_equal(got_i[0].numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_l[0].numpy(), np.asarray(want_l))


def test_connected_components_at_200_seeds_matches_jax():
    X = batch(12, 1, 800, k=6)[0]
    Z = np.asarray(jms.seed_hill_climbing(jnp.asarray(X), jnp.asarray(X[:200]), 20.0, 3))
    want = np.asarray(jms.connected_components(jnp.asarray(Z), 0.04))
    got = ms.connected_components(torch.from_numpy(Z), 0.04)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) >= 2


def test_seed_limits_of_the_kernels_are_named():
    """Past the kernels' 1024 seeds a CUDA call raises a ValueError naming
    the limit before any launch (the checks precede the device work)."""
    assert msk.MAX_SEEDS == ms.MAX_CC_SEEDS == 1024
    within = torch.zeros((1, 1025, 1025), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="1024"):
        ms.connected_components_sweep(within)
