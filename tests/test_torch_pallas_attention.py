"""The port's masked vMF attention (``ops/pallas_attention.py``) on the CPU: the
plain versions against the JAX package's Pallas kernels in interpret mode, at
the cases of tests/test_pallas_attention.py. The CUDA kernels are held to the
plain versions in tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from unseenobjectswithmeanshift_tpu.ops import pallas_attention as jpa
from unseenobjectswithmeanshift_torch.ops import pallas_attention as pa
from unseenobjectswithmeanshift_torch.ops.fused_cross_attention import TILE_KEYS
from unseenobjectswithmeanshift_torch.ops.pallas_attention import launch_plan
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401

# fp32 on both sides, summed in other orders; exp(kappa s) scales an error in
# s by kappa = 30. The JAX package holds its kernel to its reference at 2e-5
# (3e-5 for the fused projections, whose k/v sums run over E); so do we.
ATOL, ATOL_FUSED = 2e-5, 3e-5


def make(seed, B=1, H=2, Q=10, K=96, D=8, mask="random"):
    """qn normalized, raw k, v, logits; mask: random, guard (row 2 of image 0
    masked everywhere) or open (every key attends)."""
    rng = np.random.RandomState(seed)
    qn = rng.randn(B, H, Q, D).astype(np.float32)
    qn /= np.linalg.norm(qn, axis=-1, keepdims=True)
    k = rng.randn(B, H, K, D).astype(np.float32)
    v = rng.randn(B, H, K, D).astype(np.float32)
    logits = rng.randn(B, Q, K).astype(np.float32)
    if mask == "guard":
        logits[0, 2, :] = -5.0
    elif mask == "open":
        logits = np.abs(logits) + 0.1
    return qn, k, v, logits


CASES = {   # name: (make kwargs, JAX block_k)
    "plain": (dict(), 32),
    "guard": (dict(Q=6, K=64, mask="guard"), 32),
    "padded_k": (dict(K=75), 32),
    "no_mask": (dict(mask="open"), 32),
    "multibatch_multihead": (dict(B=3, H=4, Q=17, K=130, D=16), 64),
}


@pytest.mark.parametrize("raw_k", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_masked_attention_plain_matches_jax_kernel(case, raw_k):
    kw, block_k = CASES[case]
    qn, k, v, logits = make(len(case), **kw)
    if not raw_k:
        k = k / np.linalg.norm(k, axis=-1, keepdims=True)
    want = jpa.masked_hypersphere_attention(
        *map(jnp.asarray, (qn, k, v, logits)), block_k=block_k, interpret=True,
        k_normalized=not raw_k)
    before = pa.masked_hypersphere_attention.launches
    got = pa.masked_hypersphere_attention(*map(torch.from_numpy, (qn, k, v, logits)),
                                          k_normalized=not raw_k)
    assert pa.masked_hypersphere_attention.launches == before    # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_masked_attention_kv_transposed_matches_jax_kernel():
    qn, k, v, logits = make(7, B=2, H=2, Q=10, K=96, D=8)
    kT, vT = k.transpose(0, 1, 3, 2).copy(), v.transpose(0, 1, 3, 2).copy()
    want = jpa.masked_hypersphere_attention(*map(jnp.asarray, (qn, kT, vT, logits)),
                                            block_k=32, interpret=True, kv_transposed=True,
                                            k_normalized=False)
    got = pa.masked_hypersphere_attention(*map(torch.from_numpy, (qn, kT, vT, logits)),
                                          kv_transposed=True, k_normalized=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    same = pa.masked_hypersphere_attention(*map(torch.from_numpy, (qn, k, v, logits)))
    np.testing.assert_allclose(got.numpy(), same.numpy(), atol=1e-6)


def fused_inputs(seed, B=2, H=2, Q=10, K=96, D=8, E=16):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    qn = rng.randn(B, H, Q, D).astype(f32)
    qn /= np.linalg.norm(qn, axis=-1, keepdims=True)
    base = rng.randn(B, K, E).astype(f32)
    pos = rng.randn(K, E).astype(f32)
    wk = (rng.randn(E, H * D) * 0.2).astype(f32)
    bk = (rng.randn(H * D) * 0.1).astype(f32)
    wv = (rng.randn(E, H * D) * 0.2).astype(f32)
    bv = (rng.randn(H * D) * 0.1).astype(f32)
    logits = rng.randn(B, Q, K).astype(f32)
    logits[0, 3, :] = -5.0                        # the guard
    return qn, base, pos, wk, bk, wv, bv, logits


@pytest.mark.parametrize("shape", [dict(), dict(B=1, H=4, Q=17, K=75, D=8, E=24)])
def test_fused_masked_attention_plain_matches_jax_kernel(shape):
    args = fused_inputs(len(shape), **shape)
    want = jpa.fused_masked_hypersphere_attention(*map(jnp.asarray, args), block_k=32,
                                                  interpret=True)
    before = pa.fused_masked_hypersphere_attention.launches
    got = pa.fused_masked_hypersphere_attention(*map(torch.from_numpy, args))
    assert pa.fused_masked_hypersphere_attention.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_FUSED)
    # the same function as projecting outside and calling the unfused version
    qn, base, pos, wk, bk, wv, bv, logits = map(torch.from_numpy, args)
    B, H, Q, D = qn.shape
    heads = lambda x: x.reshape(B, -1, H, D).transpose(1, 2)
    unfused = pa.masked_hypersphere_attention(qn, heads((base + pos) @ wk + bk),
                                              heads(base @ wv + bv), logits,
                                              k_normalized=False)
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), atol=1e-6)


@pytest.mark.parametrize("B,K", [(1, 307_200), (20, 50_176), (3, 100)])
def test_launch_plan_bounds_the_split_length(B, K):
    # the kernels' running sums add one tile at a time over one split: at
    # most MAX_TILES_PER_SPLIT tiles (with either kernel's resident blocks),
    # every key in exactly one split
    nsplit, tps = launch_plan(B, 8, K, 132, fused=False)
    ntiles = -(-K // TILE_KEYS)
    assert tps <= pa.MAX_TILES_PER_SPLIT
    assert nsplit * tps >= ntiles > (nsplit - 1) * tps
