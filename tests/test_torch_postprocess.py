"""The port's post-processing and refinement against the JAX package on shared
inputs: label images must be equal, scores and crops equal to fp32 rounding."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from unseenobjectswithmeanshift_tpu.pipeline import postprocess as jpp
from unseenobjectswithmeanshift_tpu.pipeline import refine as jrf
from unseenobjectswithmeanshift_torch.pipeline import postprocess as pp
from unseenobjectswithmeanshift_torch.pipeline import refine as rf
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401

def t(a):
    return torch.from_numpy(np.array(a))   # a writable copy


def _instances(rng, Q=12, K=2, H=24, W=20, topk=6, embed=False):
    logits = rng.randn(Q, K + 1).astype(np.float32)
    if embed:
        me = rng.randn(Q, 8).astype(np.float32)
        mf = rng.randn(H, W, 8).astype(np.float32)
        j = jpp.instance_inference(jnp.asarray(logits), None, K, topk, mask_embed=jnp.asarray(me),
                                   mask_features=jnp.asarray(mf), out_hw=(H, W))
        p = pp.instance_inference(t(logits), None, K, topk, mask_embed=t(me),
                                  mask_features=t(mf), out_hw=(H, W))
    else:
        masks = rng.randn(Q, H, W).astype(np.float32) * 2
        j = jpp.instance_inference(jnp.asarray(logits), jnp.asarray(masks), K, topk)
        p = pp.instance_inference(t(logits), t(masks), K, topk)
    return j, p


@pytest.mark.parametrize("embed", [False, True])
def test_instance_inference_matches_jax(rng, embed):
    j, p = _instances(rng, embed=embed)
    np.testing.assert_array_equal(p.masks.numpy(), np.asarray(j.masks))
    np.testing.assert_array_equal(p.classes.numpy(), np.asarray(j.classes))
    # fp32 softmax and sigmoid means, summed in different orders
    np.testing.assert_allclose(p.scores.numpy(), np.asarray(j.scores), atol=1e-6)
    np.testing.assert_allclose(p.mask_logits.numpy(), np.asarray(j.mask_logits), atol=1e-5)


@pytest.mark.parametrize("topk,kw", [(True, dict(low_threshold=0.15)), (False, dict(score=0.2))])
def test_confident_instances_and_combine_match_jax(rng, topk, kw):
    j, p = _instances(rng, Q=16, H=16, W=16, topk=10)
    jv = jpp.get_confident_instances(j, topk=topk, num_classes=2, **kw)
    pv = pp.get_confident_instances(p, topk=topk, num_classes=2, **kw)
    np.testing.assert_array_equal(pv.valid.numpy(), np.asarray(jv.valid))
    assert pv.valid.any()
    np.testing.assert_array_equal(pp.combine_masks(pv).numpy(),
                                  np.asarray(jpp.combine_masks(jv)))


def test_filter_labels_depth_matches_jax(rng):
    label = rng.randint(0, 7, size=(20, 24)).astype(np.int32)
    z = rng.rand(20, 24).astype(np.float32)
    z[label == 3] = 0.0
    z[(label == 5) & (rng.rand(20, 24) < 0.5)] = 0.0
    want = np.asarray(jpp.filter_labels_depth(jnp.asarray(label), jnp.asarray(z), 0.5, 8))
    got = pp.filter_labels_depth(t(label), t(z), 0.5, 8).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 3).sum() == 0 and (got > 0).any()


def _label_image(rng, H=40, W=48):
    label = np.zeros((H, W), np.int32)
    label[3:15, 5:20] = 2
    label[10:30, 15:40] = 4            # overlaps 2, a gap at value 3
    label[H - 8:, W - 6:] = 5          # touches the bottom-right corner
    label[20:22, 2:4] = 6              # tiny
    return label


@pytest.mark.parametrize("with_depth", [True, False])
def test_crop_rois_matches_jax(rng, with_depth):
    H, W, T, S = 40, 48, 6, 16
    label = _label_image(rng, H, W)
    img = rng.randn(H, W, 3).astype(np.float32)
    xyz = rng.rand(H, W, 3).astype(np.float32) if with_depth else None
    j = jrf.crop_rois(jnp.asarray(img), jnp.asarray(label),
                      None if xyz is None else jnp.asarray(xyz), T, S)
    p = rf.crop_rois(t(img), t(label), None if xyz is None else t(xyz), T, S)
    np.testing.assert_array_equal(p.present.numpy(), np.asarray(j.present))
    np.testing.assert_array_equal(p.rois.numpy(), np.asarray(j.rois))
    np.testing.assert_array_equal(p.mask.numpy(), np.asarray(j.mask))
    # the same two taps and weights; the JAX package sums them in a matmul
    np.testing.assert_allclose(p.rgb.numpy(), np.asarray(j.rgb), atol=1e-6)
    if with_depth:
        np.testing.assert_allclose(p.xyz.numpy(), np.asarray(j.xyz), atol=1e-6)


@pytest.mark.parametrize("with_depth", [True, False])
def test_match_label_crop_matches_jax(rng, with_depth):
    H, W, T, S = 40, 48, 6, 16
    label = _label_image(rng, H, W)
    xyz = rng.rand(H, W, 3).astype(np.float32)
    crops = jrf.crop_rois(jnp.zeros((H, W, 3)), jnp.asarray(label), jnp.asarray(xyz), T, S)
    labels_crop = rng.randint(0, 4, size=(T, S, S)).astype(np.int32)
    labels_crop[:, :4] = 0
    depth = np.asarray(crops.xyz[..., 2]) if with_depth else None
    args = (labels_crop, np.asarray(crops.mask), np.asarray(crops.rois), depth,
            np.asarray(crops.present))
    want = np.asarray(jrf.match_label_crop(*[None if a is None else jnp.asarray(a) for a in args],
                                           (H, W)))
    got = rf.match_label_crop(*[None if a is None else t(a) for a in args], (H, W)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() >= 2


@pytest.mark.parametrize("fn", ["filter_labels_depth", "renumber_labels_by_size"])
def test_labels_outside_max_label_match_jax(rng, fn):
    # the JAX package's one-hot over max_label values gives labels >= max_label
    # (and below 0) no bin: they count nowhere and become 0
    label = rng.randint(0, 6, size=(20, 24)).astype(np.int32)
    label[:4, :5] = 6
    label[10:12, :] = 9
    label[15, 3:9] = -1
    z = rng.rand(20, 24).astype(np.float32)
    z[label == 2] = 0.0
    if fn == "filter_labels_depth":
        want = np.asarray(jpp.filter_labels_depth(jnp.asarray(label), jnp.asarray(z), 0.5, 6))
        got = pp.filter_labels_depth(t(label), t(z), 0.5, 6).numpy()
    else:
        want, want_k = map(np.asarray, jpp.renumber_labels_by_size(jnp.asarray(label), 6))
        got, got_k = pp.renumber_labels_by_size(t(label), 6)
        got = got.numpy()
        assert int(got_k) == int(want_k) == 5
    np.testing.assert_array_equal(got, want)
    assert not np.isin(got, [6, 9, -1]).any() and (got > 0).any()
