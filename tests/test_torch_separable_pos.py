"""The separable positional input of the port's cross-attention on the CPU.

The decoder passes the sine encoding as its two factors (pos_y [E/2, h],
pos_x [E/2, w]) instead of posT [E, K], so that the kernel projects h + w
rows instead of K keys. These tests hold the factors to the full encoding bit
for bit, the plain version of the separable form to the general form
(torch.equal) and to the JAX package's kernel (interpret mode) and reference
on a real sine grid, and the decoder to passing the factors.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from unseenobjectswithmeanshift_tpu.ops.fused_cross_attention import (
    fused_uoms_cross_attention as jax_fused,
    fused_uoms_cross_attention_reference as jax_reference,
)
from unseenobjectswithmeanshift_torch.models import decoder as decoder_module
from unseenobjectswithmeanshift_torch.models.decoder import MeanShiftDecoder
from unseenobjectswithmeanshift_torch.models.position_encoding import (
    position_embedding_sine, position_embedding_sine_factors,
)
from unseenobjectswithmeanshift_torch.ops.fused_cross_attention import (
    BLOCKS_PER_SM, TILE_KEYS, expand_pos, fused_uoms_cross_attention,
    fused_uoms_cross_attention_plain, launch_plan,
)
from unseenobjectswithmeanshift_torch.weights import init_random

from test_torch_cross_attention import ATOL, make_inputs, with_all_masked_rows

H, D = 4, 8
E = H * D


def sine_posT(h, w):
    """The decoder's general posT [E, K], as the port built it before it passed
    factors."""
    return position_embedding_sine(h, w, E // 2, device="cpu").reshape(h * w, E).T.contiguous()


@pytest.mark.parametrize("h,w,feats", [(6, 10, 16), (7, 9, 16), (16, 16, 48), (30, 40, 128),
                                       (224, 224, 128)])
def test_factors_expand_to_the_full_encoding_bit_for_bit(h, w, feats):
    pos_y, pos_x = position_embedding_sine_factors(h, w, feats, device="cpu")
    assert pos_y.shape == (feats, h) and pos_x.shape == (feats, w)
    full = position_embedding_sine(h, w, feats, device="cpu").reshape(h * w, 2 * feats).T
    assert torch.equal(expand_pos((pos_y, pos_x)), full.contiguous())


def separable_case(rng, h, w, B=3, Q=10):
    """make_inputs at H=4, D=8 on an h x w sine grid (K = h w, not a multiple
    of the 64-key tile), queries 0 and 3 masked everywhere (the guard).
    -> (numpy args with posT, (pos_y, pos_x) as torch tensors)."""
    args = with_all_masked_rows(make_inputs(rng, B=B, H=H, Q=Q, D=D, K=h * w))
    args[4] = sine_posT(h, w).numpy()
    return args, position_embedding_sine_factors(h, w, E // 2, device="cpu")


@pytest.mark.parametrize("h,w", [(6, 10), (7, 9)])
def test_separable_plain_equals_general_plain(rng, h, w):
    args, factors = separable_case(rng, h, w)
    t = [torch.from_numpy(a) for a in args]
    present = torch.tensor([True, False, True])
    general = fused_uoms_cross_attention_plain(*t, present=present)
    separable = fused_uoms_cross_attention_plain(*t[:4], factors, *t[5:], present=present)
    assert torch.equal(separable, general)
    assert torch.equal(fused_uoms_cross_attention_plain(*t[:4], factors, *t[5:], present=present,
                                                        tile_skip=True), general)


@pytest.mark.parametrize("h,w", [(6, 10), (7, 9)])
def test_separable_plain_matches_jax_kernel_and_reference(rng, h, w):
    args, factors = separable_case(rng, h, w)
    present = np.array([True, False, True])
    t = [torch.from_numpy(a) for a in args]
    got = fused_uoms_cross_attention_plain(*t[:4], factors, *t[5:],
                                           present=torch.from_numpy(present)).numpy()
    jargs = list(map(jnp.asarray, args))
    want_kernel = np.asarray(jax_fused(*jargs, present=jnp.asarray(present), block_k=32,
                                       block_b=2, interpret=True))
    want_ref = np.asarray(jax_reference(*jargs))
    np.testing.assert_allclose(got, want_kernel, atol=ATOL)
    np.testing.assert_allclose(got, want_ref * present[:, None, None, None], atol=ATOL)
    assert np.all(got[1] == 0)


def test_wrapper_takes_factors_on_cpu(rng):
    args, factors = separable_case(rng, 7, 9, B=2)
    t = [torch.from_numpy(a) for a in args]
    before = (fused_uoms_cross_attention.launches, fused_uoms_cross_attention.general_pos_launches)
    got = fused_uoms_cross_attention(*t[:4], factors, *t[5:])
    assert (fused_uoms_cross_attention.launches,
            fused_uoms_cross_attention.general_pos_launches) == before   # no kernel on the CPU
    assert torch.equal(got, fused_uoms_cross_attention_plain(*t))


def test_decoder_passes_the_sine_factors(monkeypatch):
    dec = init_random(MeanShiftDecoder(hidden_dim=E, num_queries=6, nheads=H, dim_feedforward=32,
                                       dec_layers=2, mask_dim=16, in_channels=8),
                      torch.Generator().manual_seed(0)).eval()
    seen = []
    real = decoder_module.fused_uoms_cross_attention

    def spy(*args, **kw):
        seen.append(args[4])
        return real(*args, **kw)

    monkeypatch.setattr(decoder_module, "fused_uoms_cross_attention", spy)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 5, 7, 8).astype(np.float32))
    mf = torch.from_numpy(rng.randn(1, 5, 7, 16).astype(np.float32))
    with torch.no_grad():
        dec(x, mf)
    assert len(seen) == 2
    for pos in seen:
        assert isinstance(pos, tuple) and [p.shape for p in pos] == [(E // 2, 5), (E // 2, 7)]
        assert torch.equal(expand_pos(pos), sine_posT(5, 7))


@pytest.mark.parametrize("B,K,sms", [(1, 307_200, 132), (8, 50_176, 132), (9, 50_176, 132),
                                     (20, 50_176, 132), (3, 100, 132), (1, 64, 4)])
def test_launch_plan_takes_no_more_waves_than_one_split_a_slot(B, K, sms):
    # one block per (split, head, image); of the cuts with no empty split,
    # the plan takes the fewest tile steps of the busiest slot, never more
    # than the cut into ceil(slots / blocks a split) splits
    nsplit, tps = launch_plan(B, 8, K, sms)
    ntiles = -(-K // TILE_KEYS)
    assert nsplit >= 1 and nsplit * tps >= ntiles > (nsplit - 1) * tps
    slots, per_split = BLOCKS_PER_SM * sms, B * 8
    steps = lambda ns, t: -(-ns * per_split // slots) * t
    want = min(ntiles, -(-slots // per_split))
    naive_tps = -(-ntiles // want)
    assert steps(nsplit, tps) <= steps(-(-ntiles // naive_tps), naive_tps)
