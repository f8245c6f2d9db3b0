"""The cross-attention (rows 1-2) at the key counts of the standard-backbone
pyramid, on the CPU: the port's plain version against the JAX package's
Pallas kernel in interpret mode.

The R50 decoder attends three levels: K = 300 / 1,200 / 4,800 at 480 x 640
and K = 49 / 196 / 784 on 224 x 224 crops. These tests take the ragged
small ones: 49 (7 x 7, less than one 64-key tile and not a multiple of 4),
196 (14 x 14) and 300 (15 x 20), in the separable positional form the
decoder passes (the JAX kernel takes the expanded posT), with an absent
image, in fp32 (atol 2e-5, the JAX package's own kernel-to-reference
tolerance) and bf16 (one bf16 ulp of the output's scale, as
tests/test_torch_bf16.py), dense and with tile skipping against the JAX
``tile_plan``. The CUDA kernel is held against the plain version at these
shapes in tests/test_torch_cuda.py and chip_smoke.py's ``r50_check``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from unseenobjectswithmeanshift_tpu.ops.fused_cross_attention import (
    fused_uoms_cross_attention as jax_fused, mf_tile_bounds, plan_tile_skip,
)
from unseenobjectswithmeanshift_torch.ops.fused_cross_attention import (
    TILE_KEYS, expand_pos, fused_uoms_cross_attention, fused_uoms_cross_attention_plain,
    launch_plan,
)

from test_torch_cross_attention import make_inputs
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401

SHAPES = {49: (7, 7), 196: (14, 14), 300: (15, 20)}
ATOL = 2e-5
TWIN_TOL = 2.0 ** -8
PRESENT = np.array([True, False, True])


def _inputs(K, concentrated: bool):
    """make_inputs at B = 3, the positional input as sine-like factors;
    concentrated: every query attends to keys 20..39 only (tiles past the
    first are skipped where K > 64)."""
    rng = np.random.RandomState(K)
    args = [np.array(a) for a in make_inputs(rng, B=3, K=K)]
    h, w = SHAPES[K]
    E = args[4].shape[0]
    pos_y = np.sin(rng.randn(E // 2, h)).astype(np.float32)
    pos_x = np.cos(rng.randn(E // 2, w)).astype(np.float32)
    if concentrated:
        mf, me = args[2] * 0.02, args[3] * 0.02
        mf[:, 0, :] = 1.0
        mf[:, 0, 20:40] = -1.0
        me[:, :, 0] = -5.0
        args[2], args[3] = mf, me
    return args, (pos_y, pos_x)


def _jax_args(args, pos, dtype):
    posT = expand_pos(tuple(torch.from_numpy(p) for p in pos)).numpy()
    return [jnp.asarray(a, dtype) for a in args[:4] + [posT] + args[5:]]


def _torch_args(jargs, pos, dtype):
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype) for a in jargs]
    t[4] = tuple(torch.from_numpy(p).to(dtype) for p in pos)
    return t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile_skip", [False, True])
@pytest.mark.parametrize("K", sorted(SHAPES))
def test_plain_matches_jax_kernel_at_pyramid_key_counts(K, tile_skip, dtype):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    args, pos = _inputs(K, concentrated=tile_skip)
    jargs = _jax_args(args, pos, jdt)
    present = jnp.asarray(PRESENT)
    plan = (plan_tile_skip(jargs[3], *mf_tile_bounds(jargs[2], TILE_KEYS), 1, present=present)
            if tile_skip else None)
    # the JAX kernel's own key block: the plan's 64 keys with tile skipping,
    # else 32 (XLA:CPU's interpreter refuses one bf16 product of the 64-key
    # block at K = 49; the block sets the JAX kernel's summation order only)
    want = jax_fused(*jargs, present=present, tile_plan=plan,
                     block_k=TILE_KEYS if tile_skip else 32, block_b=1, interpret=True)
    targs = _torch_args(jargs, pos, tdt)
    got = fused_uoms_cross_attention(*targs, present=torch.from_numpy(PRESENT),
                                     tile_skip=tile_skip)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=ATOL if dtype == "float32" else TWIN_TOL, rtol=0)
    # the general positional form is the same function
    general = fused_uoms_cross_attention_plain(*targs[:4], expand_pos(targs[4]), *targs[5:],
                                               present=torch.from_numpy(PRESENT),
                                               tile_skip=tile_skip)
    assert torch.equal(general, got)
    if tile_skip:
        dense = fused_uoms_cross_attention(*targs, present=torch.from_numpy(PRESENT))
        assert torch.equal(got, dense)
        if K > TILE_KEYS:
            assert not np.asarray(plan.occ)[0].all()            # a tile is skipped


@pytest.mark.parametrize("B,K", [(1, 300), (1, 1200), (1, 4800), (20, 49), (20, 196),
                                 (20, 784)])
def test_launch_plan_at_pyramid_key_counts(B, K):
    """Few tiles to cut (1 at K = 49, 75 at K = 4,800): every split holds
    at least one tile, together they cover K, and none is empty."""
    nsplit, per = launch_plan(B, 8, K, 132)
    ntiles = -(-K // TILE_KEYS)
    assert 1 <= nsplit <= ntiles and nsplit * per >= ntiles and (nsplit - 1) * per < ntiles
