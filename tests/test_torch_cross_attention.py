"""The port's fused cross-attention on the CPU: its plain PyTorch version
against the JAX package's Pallas kernel (interpret mode) and its pure-JAX
reference. The CUDA kernel is held against the plain version in
tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from unseenobjectswithmeanshift_tpu.ops.fused_cross_attention import (
    fused_uoms_cross_attention as jax_fused,
    fused_uoms_cross_attention_reference as jax_reference,
)
from unseenobjectswithmeanshift_torch.ops.fused_cross_attention import (
    TILE_KEYS, fused_uoms_cross_attention, fused_uoms_cross_attention_plain, launch_plan,
)
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401

# Both sides are fp32 over at most a few hundred keys; they differ only in
# summation order, and exp(kappa * s) scales an error in s by kappa = 30.
# The JAX package holds its own kernel to its reference at 2e-5; so do we.
ATOL = 2e-5


def make_inputs(rng, B=2, H=4, Q=10, D=8, K=100, C=16, Cm=24, decisive=3.0):
    E = H * D
    qn = rng.randn(B, H, Q, D).astype(np.float32)
    qn /= np.linalg.norm(qn, axis=-1, keepdims=True)
    feat = rng.randn(B, C, K).astype(np.float32) * 0.3
    mf = rng.randn(B, Cm, K).astype(np.float32) * 0.3
    me = rng.randn(B, Q, Cm).astype(np.float32) * decisive   # mask logits away from 0
    pos = rng.randn(E, K).astype(np.float32) * 0.3
    awk = rng.randn(C, E).astype(np.float32) * 0.2
    awv = rng.randn(C, E).astype(np.float32) * 0.2
    wk = rng.randn(E, E).astype(np.float32) * 0.1
    ck = rng.randn(E).astype(np.float32) * 0.1
    cv = rng.randn(E).astype(np.float32) * 0.1
    return [qn, feat, mf, me, pos, awk, awv, wk, ck, cv]


def with_all_masked_rows(args, rows=(0, 3)):
    """Mask-feature channel 0 positive everywhere; the given queries weight only
    channel 0, negatively: every key is masked for them (the guard fires)."""
    mf, me = args[2].copy(), args[3].copy()
    mf[:, 0, :] = np.abs(mf[:, 0, :]) + 0.1
    for q in rows:
        me[:, q, :] = 0.0
        me[:, q, 0] = -5.0
    assert (np.einsum("bqc,bck->bqk", me, mf)[:, list(rows)] < 0).all()
    return args[:2] + [mf, me] + args[4:]


def plain(args, present=None, kappa=30.0):
    t = [torch.from_numpy(a) for a in args]
    p = None if present is None else torch.from_numpy(present)
    return fused_uoms_cross_attention_plain(*t, present=p, kappa=kappa).numpy()


@pytest.mark.parametrize("B,Q,K,kappa", [(2, 10, 100, 30.0), (3, 5, 90, 20.0),
                                         (1, 16, 257, 30.0)])
def test_plain_matches_jax_kernel_and_reference(rng, B, Q, K, kappa):
    args = make_inputs(rng, B=B, Q=Q, K=K)
    want_kernel = np.asarray(jax_fused(*map(jnp.asarray, args), kappa=kappa, block_k=32,
                                       block_b=2, interpret=True))
    want_ref = np.asarray(jax_reference(*map(jnp.asarray, args), kappa=kappa))
    got = plain(args, kappa=kappa)
    np.testing.assert_allclose(got, want_kernel, atol=ATOL)
    np.testing.assert_allclose(got, want_ref, atol=ATOL)


def test_plain_all_masked_row_guard_matches_jax(rng):
    args = with_all_masked_rows(make_inputs(rng))
    want = np.asarray(jax_fused(*map(jnp.asarray, args), block_k=32, interpret=True))
    got = plain(args)
    np.testing.assert_allclose(got, want, atol=ATOL)
    # a guarded row attends to every key: same as a query whose mask is all open
    open_args = list(args)
    open_args[3] = args[3].copy()
    open_args[3][:, 0, 0] = 5.0
    np.testing.assert_allclose(got[:, :, 0], plain(open_args)[:, :, 0], atol=ATOL)


def test_plain_present_matches_jax(rng):
    args = make_inputs(rng, B=4)
    present = np.array([True, False, True, False])
    want = np.asarray(jax_fused(*map(jnp.asarray, args), present=jnp.asarray(present),
                                block_k=32, block_b=2, interpret=True))
    got = plain(args, present=present)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.all(got[1] == 0) and np.all(got[3] == 0)


def test_wrapper_runs_plain_version_on_cpu(rng):
    args = make_inputs(rng, K=70)
    before = fused_uoms_cross_attention.launches
    got = fused_uoms_cross_attention(*[torch.from_numpy(a) for a in args]).numpy()
    assert fused_uoms_cross_attention.launches == before   # no kernel on the CPU
    np.testing.assert_array_equal(got, plain(args))


@pytest.mark.parametrize("B,K,sms", [(1, 307_200, 132), (8, 50_176, 132), (20, 50_176, 132),
                                     (3, 100, 132), (1, 64, 4)])
def test_launch_plan_covers_every_key_once(B, K, sms):
    nsplit, tps = launch_plan(B, 8, K, sms)
    ntiles = -(-K // TILE_KEYS)
    assert nsplit >= 1 and nsplit * tps >= ntiles > (nsplit - 1) * tps   # no empty split
