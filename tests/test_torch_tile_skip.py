"""Tile skipping in the port's fused cross-attention, on the CPU, against the
JAX package.

The port skips a 64-key tile of an image when no query of the image has an
unmasked key in it (``me . mf >= 0``; a query masked everywhere counts as
unmasked everywhere, the guard). The test is exact, so the output equals the
dense output bit for bit. The JAX package certifies tiles with an interval
bound instead (``plan_tile_skip``), and re-runs densely when a guard row fires
on an image with skipped tiles. Held here:

- the port's plain tile-skipping version against the JAX kernel run with a
  ``tile_plan`` (interpret mode, 64-key tiles), atol 2e-5, as the JAX package
  holds its own kernel to its reference;
- every tile the JAX plan skips is skipped by the port, except on an image
  with a guard query, where the port keeps every tile;
- every tile the port skips is masked for every query in fp64 logits;
- the tile-skipping decoder and two-stage predictor against the JAX package
  and, bit for bit, against the port's dense ones.

The CUDA kernel is held to the dense kernel with ``torch.equal`` in
tests/test_torch_cuda.py.
"""

import copy
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from unseenobjectswithmeanshift_tpu.models import decoder as jax_decoder_mod
from unseenobjectswithmeanshift_tpu.models.decoder import MeanShiftDecoder as JaxDecoder
from unseenobjectswithmeanshift_tpu.ops.fused_cross_attention import (
    fused_uoms_cross_attention as jax_fused, mf_tile_bounds, plan_tile_skip,
)
from unseenobjectswithmeanshift_tpu.pipeline.two_stage import TwoStagePredictor
from unseenobjectswithmeanshift_tpu.utils.checkpoint import convert_msmformer_checkpoint
from unseenobjectswithmeanshift_torch.models.decoder import MeanShiftDecoder
from unseenobjectswithmeanshift_torch.ops.fused_cross_attention import (
    TILE_KEYS, fused_uoms_cross_attention, fused_uoms_cross_attention_plain, tile_occupancy,
    unmasked_keys,
)
from unseenobjectswithmeanshift_torch.pipeline.factory import build_two_stage_predictor
from unseenobjectswithmeanshift_torch.weights import init_random

from test_torch_cross_attention import make_inputs
from test_torch_decoder import assert_close
from test_torch_two_stage import _shared_variables
from torch_port_cases import E, FF, L, MD, NH, Q, rgbd, small_configs
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401

ATOL = 2e-5   # fp32 on both sides, summed in different orders (kappa = 30)
BLOCK_B = 2


def concentrated(args, open_keys=(70, 140), guard=False):
    """Mask features whose channel 0 is +1 except on an open window of keys,
    where it is -1; every query weights channel 0 by -5 and the others by
    little, so only the window's keys are unmasked (for every query). With
    guard, query 0 of image 0 is masked everywhere instead."""
    mf, me = args[2] * 0.02, args[3] * 0.02
    mf[:, 0, :] = 1.0
    mf[:, 0, open_keys[0]:open_keys[1]] = -1.0
    me[:, :, 0] = -5.0
    if guard:
        mf[0, 1, :] = np.abs(mf[0, 1, :]) + 0.1
        me[0, 0, :] = 0.0
        me[0, 0, 1] = -5.0
        assert (me[0, 0] @ mf[0] < 0).all()
    return args[:2] + [mf, me] + args[4:]


CASES = {
    "dense": lambda rng: make_inputs(rng, B=3, K=300),
    "concentrated": lambda rng: concentrated(make_inputs(rng, B=4, K=300)),
    "concentrated_guard": lambda rng: concentrated(make_inputs(rng, B=4, K=300), guard=True),
}
PRESENT = {3: np.array([True, False, True]), 4: np.array([True, False, True, True])}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_tile_skip_matches_jax_tile_plan(rng, case):
    args = CASES[case](rng)
    B = args[0].shape[0]
    present = PRESENT[B]
    jargs = list(map(jnp.asarray, args))
    plan = plan_tile_skip(jargs[3], *mf_tile_bounds(jargs[2], TILE_KEYS), BLOCK_B,
                          present=jnp.asarray(present))
    want = np.asarray(jax_fused(*jargs, present=jnp.asarray(present), tile_plan=plan,
                                block_k=TILE_KEYS, block_b=BLOCK_B, interpret=True))
    t = [torch.from_numpy(a) for a in args]
    p = torch.from_numpy(present)
    got = fused_uoms_cross_attention_plain(*t, present=p, tile_skip=True)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)

    occ = tile_occupancy(unmasked_keys(t[3] @ t[2]), p).numpy()
    jax_occ = np.asarray(plan.occ)[:B].astype(bool)
    logits = np.einsum("bqc,bck->bqk", args[3].astype(np.float64), args[2].astype(np.float64))
    guard_image = (logits < 0).all(-1).any(-1) & present
    assert not (occ & ~present[:, None]).any()
    for b in range(B):
        if guard_image[b]:
            assert occ[b].all(), "a guard query must pin every tile of its image"
        else:
            assert not (occ[b] & ~jax_occ[b]).any(), "the port keeps a tile JAX certified"
        for tt in np.flatnonzero(~occ[b] & present[b]):
            assert (logits[b, :, tt * TILE_KEYS:(tt + 1) * TILE_KEYS] < 0).all()
    skipped = int((~occ & present[:, None]).sum())
    if case == "dense":
        assert skipped == 0
    else:
        # 5 tiles of 64 keys, the window at keys 70..139 lies in tiles 1-2
        assert skipped == 3 * int((present & ~guard_image).sum())


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_skip_equals_dense_bit_for_bit(rng, case):
    t = [torch.from_numpy(a) for a in CASES[case](rng)]
    p = torch.from_numpy(PRESENT[t[0].shape[0]])
    dense = fused_uoms_cross_attention_plain(*t, present=p)
    before = fused_uoms_cross_attention.launches
    for kw in (dict(tile_skip=True), dict(tile_skip=True, tile_skip_force_all=True)):
        assert torch.equal(fused_uoms_cross_attention(*t, present=p, **kw), dense)
    assert fused_uoms_cross_attention.launches == before     # CPU: the plain version


def concentrated_decoder(tile_skip):
    """The port's decoder at the small widths, with decisive masks that
    concentrate: the mask head's last layer x30 and a bias of -1000 on mask
    channel 0, which concentrated_features() sets to +1 outside a blob."""
    dec = MeanShiftDecoder(hidden_dim=E, num_queries=Q, nheads=NH, dim_feedforward=FF,
                           dec_layers=L, mask_dim=MD, in_channels=64, tile_skip=tile_skip)
    init_random(dec, torch.Generator().manual_seed(1))
    with torch.no_grad():
        lin = dec.mask_embed.layers[2]
        lin.weight *= 30.0
        lin.bias *= 30.0
        lin.bias[0] = -1000.0
    return dec.eval()


def concentrated_features(rng, h=16, w=16):
    x = rng.randn(1, h, w, 64).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    mf = rng.randn(1, h, w, MD).astype(np.float32) * 0.3
    mf[..., 0] = 1.0
    mf[0, 5:7, 2:14, 0] = -1.0             # keys 82..109: tile 1 of 4
    return x, mf


def test_decoder_tile_skip_matches_jax_and_dense(rng, monkeypatch):
    x, mf = concentrated_features(rng)
    dense, skip = concentrated_decoder(False), concentrated_decoder(True)
    skip.load_state_dict(dense.state_dict())
    with torch.no_grad():
        got_dense = dense(torch.from_numpy(x), torch.from_numpy(mf), materialize_masks=True)
        got = skip(torch.from_numpy(x), torch.from_numpy(mf), materialize_masks=True)
    for key in ("pred_logits", "mask_embed", "pred_masks"):
        assert torch.equal(got[key], got_dense[key]), key
    masks = got["pred_masks"].numpy()
    assert (masks[0, :, 5:7, 2:14] > 0).all() and (masks.reshape(Q, -1) > 0).sum(-1).max() <= 24

    monkeypatch.setattr(jax_decoder_mod, "fused_uoms_cross_attention",
                        partial(jax_fused, interpret=True))
    monkeypatch.setattr(jax_decoder_mod, "select_blocks", lambda K: (TILE_KEYS, BLOCK_B))
    sd = {f"sem_seg_head.predictor.{k}": v.numpy() for k, v in dense.state_dict().items()}
    params = convert_msmformer_checkpoint(sd)["params"]["predictor"]
    jdec = JaxDecoder(hidden_dim=E, num_queries=Q, nheads=NH, dim_feedforward=FF,
                      dec_layers=L, mask_dim=MD, in_channels=64, use_pallas=True,
                      tile_skip=True)
    want = jdec.apply({"params": params}, [jnp.asarray(x)], jnp.asarray(mf))
    for key in ("pred_logits", "pred_masks"):
        assert_close(got[key].numpy(), want[key], key)


def test_two_stage_tile_skip_labels_equal_jax_and_dense(rng):
    jc, jcc, pc, pcc = small_configs()
    v1, v2 = _shared_variables()
    img, xyz = rgbd(rng)
    jl, jr = TwoStagePredictor(jc, jcc)._forward(
        jax.tree.map(jnp.asarray, v1), jax.tree.map(jnp.asarray, v2),
        jnp.asarray(img), jnp.asarray(xyz), osd=False, refine=True)
    labels = {}
    for tile_skip in (False, True):
        pred = build_two_stage_predictor(variables=v1, variables_crop=v2, device="cpu",
                                         cfg=copy.deepcopy(pc), cfg_crop=copy.deepcopy(pcc),
                                         tile_skip=tile_skip)
        assert pred.model.sem_seg_head.predictor.tile_skip is tile_skip
        assert pred.model_crop.sem_seg_head.predictor.tile_skip is tile_skip
        s1 = pred.stage1(torch.from_numpy(img), torch.from_numpy(xyz))
        labels[tile_skip] = (s1.labels, pred.refine(s1), int(s1.crops[0].present.sum()))
    assert len(np.unique(np.asarray(jl))) >= 3 and labels[True][2] >= 2
    for got in labels[True][:2]:
        assert got.dtype == torch.int32
    np.testing.assert_array_equal(labels[True][0].numpy(), np.asarray(jl))
    np.testing.assert_array_equal(labels[True][1].numpy(), np.asarray(jr))
    assert torch.equal(labels[True][0], labels[False][0])
    assert torch.equal(labels[True][1], labels[False][1])
