"""The port's backbone and small ops against the JAX package on the CPU:
SEGNET embeddings (two ResNet34-8s towers, 'add' fusion, L2-normalize),
the resize conventions, the sine positional encoding, the vMF
self-attention, the attention-mask bias and the preprocessing."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from unseenobjectswithmeanshift_tpu.models.position_encoding import (
    position_embedding_sine as jax_pe,
)
from unseenobjectswithmeanshift_tpu.models.segnet import SEGNET as JaxSEGNET
from unseenobjectswithmeanshift_tpu.ops import resize as jax_resize
from unseenobjectswithmeanshift_tpu.ops.hypersphere_attention import (
    MhaParams, bool_mask_to_bias as jax_bias, meanshift_attention as jax_msa,
)
from unseenobjectswithmeanshift_tpu.utils import preprocess as jax_pre
from unseenobjectswithmeanshift_torch.models.position_encoding import position_embedding_sine
from unseenobjectswithmeanshift_torch.models.segnet import SEGNET
from unseenobjectswithmeanshift_torch.ops import resize
from unseenobjectswithmeanshift_torch.ops.hypersphere_attention import (
    bool_mask_to_bias, meanshift_attention,
)
from unseenobjectswithmeanshift_torch.utils import preprocess
from unseenobjectswithmeanshift_torch.weights import _backbone
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401


def _perturb_bn(tree, rng):
    """Non-trivial BatchNorm statistics and affine terms, in place."""
    for k, v in tree.items():
        if isinstance(v, dict):
            if "mean" in v:
                v["mean"] = rng.randn(*v["mean"].shape).astype(np.float32) * 0.1
                v["var"] = (1 + 0.5 * rng.rand(*v["var"].shape)).astype(np.float32)
            elif "scale" in v:
                v["scale"] = (1 + 0.2 * rng.randn(*v["scale"].shape)).astype(np.float32)
                v["bias"] = (0.1 * rng.randn(*v["bias"].shape)).astype(np.float32)
            else:
                _perturb_bn(v, rng)


def test_segnet_embeddings_match_jax(rng):
    H, W = 64, 64
    img = rng.rand(1, H, W, 3).astype(np.float32) - 0.4
    xyz = (rng.rand(1, H, W, 3) * 1.5).astype(np.float32)
    jnet = JaxSEGNET()
    variables = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(0), img, xyz))
    _perturb_bn(variables["params"], rng)
    _perturb_bn(variables["batch_stats"], rng)
    want = np.asarray(jnet.apply(variables, img, xyz))

    sd = {}
    for tower in ("fcn", "fcn_depth"):
        _backbone(variables["params"][tower], variables["batch_stats"][tower],
                  f"{tower}.resnet34_8s.", sd)
    net = SEGNET().eval()
    net.load_state_dict(sd)
    with torch.no_grad():
        got = net(torch.from_numpy(img), torch.from_numpy(xyz)).numpy()
    # unit-norm 64-d embeddings after 2 x 37 fp32 convs; JAX runs HIGHEST
    # precision, torch fp32 on the CPU: agreement to ~1e-6, held at 2e-5
    assert got.shape == (1, H, W, 64)
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("in_hw,out_hw,align", [((8, 8), (64, 64), True),
                                                ((8, 10), (30, 17), False),
                                                ((24, 24), (7, 9), False)])
def test_resize_bilinear_matches_jax(rng, in_hw, out_hw, align):
    x = rng.randn(2, *in_hw, 3).astype(np.float32)
    want = np.asarray(jax_resize.resize_bilinear(jnp.asarray(x), out_hw, align_corners=align))
    got = resize.resize_bilinear(torch.from_numpy(x), out_hw, align_corners=align).numpy()
    # F.interpolate computes source indices and weights by its own fp32
    # formula, the JAX package by interpolation matrices: ~1 ulp of |x| < 5
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("in_hw,out_hw", [((7, 9), (32, 20)), ((32, 32), (5, 7))])
def test_resize_nearest_matches_jax(rng, in_hw, out_hw):
    x = rng.randint(0, 9, size=(*in_hw, 2)).astype(np.int32)
    want = np.asarray(jax_resize.resize_nearest(jnp.asarray(x), out_hw))
    np.testing.assert_array_equal(resize.resize_nearest(torch.from_numpy(x), out_hw).numpy(), want)


def test_position_encoding_matches_jax():
    want = np.asarray(jax_pe(12, 20, 48))
    got = position_embedding_sine(12, 20, 48, device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)   # fp32 sin/cos of the same angles


def test_meanshift_self_attention_matches_jax(rng):
    B, L, E, H = 2, 12, 32, 4
    x = rng.randn(B, L, E).astype(np.float32)
    w = [rng.randn(E, E).astype(np.float32) * 0.2 for _ in range(4)]
    b = [rng.randn(E).astype(np.float32) * 0.1 for _ in range(4)]
    p = MhaParams(*map(jnp.asarray, w[:3]), *map(jnp.asarray, b[:3]), jnp.asarray(w[3]),
                  jnp.asarray(b[3]))
    want, want_attn = jax_msa(p, jnp.asarray(x), jnp.asarray(x), jnp.asarray(x), H)
    tw = lambda a: torch.from_numpy(np.ascontiguousarray(a.T))   # [in, out] -> [out, in]
    t = torch.from_numpy(x)
    got, got_attn = meanshift_attention(
        t, t, t, torch.cat([tw(a) for a in w[:3]]), torch.from_numpy(np.concatenate(b[:3])),
        tw(w[3]), torch.from_numpy(b[3]), H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(want_attn), atol=1e-5)


def test_bool_mask_to_bias_matches_jax(rng):
    m = rng.rand(2, 5, 7) < 0.6
    m[0, 2] = True                      # a fully masked row: the guard opens it
    want = np.asarray(jax_bias(jnp.asarray(m)))
    got = bool_mask_to_bias(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 0, 2] == 0).all()


def test_preprocess_matches_jax(rng):
    depth = (rng.rand(30, 50) * 2).astype(np.float32)
    want = jax_pre.compute_xyz(depth, 500.0, 510.0, 24.5, 14.0)
    got = preprocess.compute_xyz(torch.from_numpy(depth), 500.0, 510.0, 24.5, 14.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)   # the same fp32 ops
    im = rng.randint(0, 256, size=(30, 50, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        preprocess.normalize_image_ucn(torch.from_numpy(im)).numpy(),
        jax_pre.normalize_image_ucn(im))
    x = rng.rand(1, 30, 50, 3).astype(np.float32)
    want_p, want_hw = jax_pre.pad_to_multiple(x, 32)
    got_p, got_hw = preprocess.pad_to_multiple(torch.from_numpy(x), 32)
    assert got_hw == want_hw == (30, 50)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
