"""The port's standard-backbone modules against the JAX package on the CPU.

Deformable attention, the detectron2 ResNet50, the three pixel decoders and
the 3-level decoder, at small shapes. Weights are drawn by the port
(``init_random``) and carried to JAX by the JAX package's converters
(``utils/checkpoint.py``), except for the FPN and transformer-encoder
pixel decoders, for which the JAX package has no converter: those go the
other way, JAX init through the port's ``from_jax_variables``.

Two settings differ between the packages on purpose, and the tests set the
JAX package's value on the port's module instances so that the functions
compare: GroupNorm eps (the port follows the reference's 1e-5, the JAX
package leaves flax's 1e-6), and the MSDeformAttn pixel decoder's level
embedding order (the reference adds level_embed[l] to level l, res5 first;
the JAX package adds level_embed[L-1-l], so its converter's straight copy is
reversed here). ROADMAP.md section 3 lists both under "JAX-side defects".
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from unseenobjectswithmeanshift_tpu.models.backbone_resnet import ResNetBackbone as JaxResNet
from unseenobjectswithmeanshift_tpu.models.decoder import MeanShiftDecoder as JaxDecoder
from unseenobjectswithmeanshift_tpu.models import pixel_decoders as jax_pd
from unseenobjectswithmeanshift_tpu.ops import ms_deform_attn as jax_msda
from unseenobjectswithmeanshift_tpu.utils.checkpoint import (
    _convert_d2_resnet, _convert_msdeformattn_pixel_decoder, convert_msmformer_checkpoint,
)
from unseenobjectswithmeanshift_torch.models.backbone_resnet import ResNetBackbone
from unseenobjectswithmeanshift_torch.models.decoder import MeanShiftDecoder
from unseenobjectswithmeanshift_torch.models import pixel_decoders as pd
from unseenobjectswithmeanshift_torch.ops import ms_deform_attn as msda
from unseenobjectswithmeanshift_torch.weights import _pixel_decoder, init_random

from torch_port_cases import E, FF, MD, NH, Q
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401

GEN = lambda seed: torch.Generator().manual_seed(seed)   # noqa: E731
JAX_GN_EPS = 1e-6
# fp32 on both sides, summed in different orders (JAX at HIGHEST precision)
ATOL, RTOL = 2e-5, 1e-5


def _np_state(model, prefix=""):
    return {prefix + k: v.detach().numpy() for k, v in model.state_dict().items()}


def _jax_gn_eps(model):
    for m in model.modules():
        if isinstance(m, torch.nn.GroupNorm):
            m.eps = JAX_GN_EPS
    return model


def _feats(rng, channels, base, B=1):
    """NHWC numpy res2..res5 features at base x (3/2) base, halving."""
    h, w = base, base * 3 // 2
    return {f"res{i + 2}": rng.randn(B, h >> i, w >> i, c).astype(np.float32)
            for i, c in enumerate(channels)}


def _nchw(feats):
    return {k: torch.from_numpy(v).permute(0, 3, 1, 2) for k, v in feats.items()}


def test_ms_deform_attn_core_matches_jax(rng):
    """Locations spread past [0, 1] on both sides, so the zero padding and
    the border taps are exercised."""
    shapes = [(3, 5), (6, 4), (1, 2)]
    B, NHd, D, Lq, P = 2, 4, 8, 7, 3
    value = rng.randn(B, sum(h * w for h, w in shapes), NHd, D).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, (B, Lq, NHd, len(shapes), P, 2)).astype(np.float32)
    aw = rng.rand(B, Lq, NHd, len(shapes), P).astype(np.float32)
    got = msda.ms_deform_attn_core(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                                   torch.from_numpy(aw))
    want = jax_msda.ms_deform_attn_core(jnp.asarray(value), shapes, jnp.asarray(loc),
                                        jnp.asarray(aw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_ms_deform_attn_module_matches_jax(rng):
    """Random (nonzero) offset and weight kernels: the init zeroes them."""
    shapes = [(2, 3), (4, 6), (8, 12)]
    C, H, L, P = 32, 4, 3, 4
    m = init_random(msda.MSDeformAttn(C, L, H, P), GEN(3)).eval()
    with torch.no_grad():
        m.sampling_offsets.weight.normal_(0, 0.5, generator=GEN(4))
        m.attention_weights.weight.normal_(0, 0.5, generator=GEN(5))
    n = sum(h * w for h, w in shapes)
    src = rng.randn(1, n, C).astype(np.float32)
    q = rng.randn(1, n, C).astype(np.float32)
    ref = pd.encoder_reference_points(shapes, L, "cpu").numpy()
    with torch.no_grad():
        got = m(torch.from_numpy(q), torch.from_numpy(ref), torch.from_numpy(src), shapes)
    params = {name: {"kernel": sub.weight.detach().numpy().T, "bias": sub.bias.detach().numpy()}
              for name, sub in m.named_children()}
    want = jax_msda.MSDeformAttn(C, L, H, P).apply({"params": params}, jnp.asarray(q),
                                                   jnp.asarray(ref), jnp.asarray(src), shapes)
    # the offsets reach O(1) pixels, so this checks the sampling, not just the zero-offset grid
    assert float(m.sampling_offsets.weight.detach().abs().max()) > 0.5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    ref_j = np.asarray(jax_pd.encoder_reference_points(shapes, L))
    np.testing.assert_array_equal(ref[0], ref_j)


def test_resnet50_backbone_matches_jax(rng):
    """Full ResNet50 depth on a 64 x 96 image, with random frozen-BN
    statistics."""
    m = init_random(ResNetBackbone(), GEN(1)).eval()
    with torch.no_grad():
        for k, buf in m.named_buffers():
            if k.endswith("running_mean"):
                buf.normal_(0, 0.1, generator=GEN(2))
            elif k.endswith("running_var"):
                buf.uniform_(0.5, 2.0, generator=GEN(3))
    x = rng.randn(1, 64, 96, 3).astype(np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    params, stats = {}, {}
    _convert_d2_resnet(_np_state(m, "backbone."), params, stats)
    want = jax.jit(JaxResNet().apply)(
        {"params": params["backbone"], "batch_stats": stats["backbone"]}, jnp.asarray(x))
    for k in ("res2", "res3", "res4", "res5"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(), w,
                                   atol=1e-4 * max(1.0, float(np.abs(w).max())), rtol=1e-4,
                                   err_msg=k)


def test_msdeformattn_pixel_decoder_matches_jax(rng):
    ch = (32, 64, 96, 128)
    m = _jax_gn_eps(init_random(pd.MSDeformAttnPixelDecoder(ch, 64, MD, enc_layers=2),
                                GEN(6))).eval()
    with torch.no_grad():
        for layer in m.transformer.encoder.layers:
            layer.self_attn.sampling_offsets.weight.normal_(0, 0.3, generator=GEN(7))
    feats = _feats(rng, ch, 16)
    with torch.no_grad():
        mf, tf, ms = m(_nchw(feats))
    params = {}
    _convert_msdeformattn_pixel_decoder(_np_state(m, "sem_seg_head.pixel_decoder."), params)
    params["pixel_decoder"]["level_embed"] = params["pixel_decoder"]["level_embed"][::-1]
    want = jax.jit(jax_pd.MSDeformAttnPixelDecoder(ch, conv_dim=64, mask_dim=MD,
                                                   enc_layers=2).apply)(
        {"params": params["pixel_decoder"]}, {k: jnp.asarray(v) for k, v in feats.items()})
    _compare_pixel_decoder((mf, tf, ms), want)


def _compare_pixel_decoder(got, want):
    mf, tf, ms = got
    pairs = [(mf, want[0]), (tf, want[1])] + list(zip(ms, want[2]))
    assert len(ms) == len(want[2]) == 3
    for g, w in pairs:
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("name", ["fpn", "transformer_enc"])
def test_fpn_pixel_decoders_match_jax(rng, name):
    """JAX init carried to the port by from_jax_variables (no JAX converter
    exists for these two)."""
    ch = (32, 64, 96, 128)
    feats = _feats(rng, ch, 16)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    if name == "fpn":
        jm = jax_pd.BasePixelDecoder(ch, conv_dim=32, mask_dim=MD)
        m = pd.BasePixelDecoder(ch, 32, MD)
    else:
        jm = jax_pd.TransformerEncoderPixelDecoder(ch, conv_dim=32, mask_dim=MD, enc_layers=2,
                                                   nheads=4, dim_feedforward=64)
        m = pd.TransformerEncoderPixelDecoder(ch, 32, MD, enc_layers=2, nheads=4,
                                              dim_feedforward=64)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jfeats))
    for leaf in variables["params"].values():      # GroupNorm scales and biases off identity
        if "scale" in leaf and "kernel" not in leaf:
            leaf["scale"] = leaf["scale"] + rng.uniform(-0.5, 0.5, leaf["scale"].shape)
            leaf["bias"] = leaf["bias"] + rng.uniform(-0.5, 0.5, leaf["bias"].shape)
    sd = {}
    _pixel_decoder(variables["params"], sd)
    P = "sem_seg_head.pixel_decoder."
    m.load_state_dict({k[len(P):]: v for k, v in sd.items()})
    m = _jax_gn_eps(m).eval()
    with torch.no_grad():
        got = m(_nchw(feats))
    want = jax.jit(jm.apply)(variables, jfeats)
    if name == "fpn":
        assert got[1] is None and want[1] is None
        got, want = (got[0], got[0], got[2]), (want[0], want[0], want[2])
    _compare_pixel_decoder(got, want)


def _decisive(model):
    with torch.no_grad():
        lin = model.mask_embed.layers[2]
        lin.weight *= 30.0
        lin.bias *= 30.0
    return model


def test_three_level_decoder_matches_jax(rng):
    """Three levels, 3 layers (one per level), mask features at twice the
    finest level: the port resizes the mask features once per level, the
    JAX package (unfused on the CPU) resizes the mask logits of every layer;
    the two are equal up to rounding, so the mask head is made decisive
    (x30, as tests/test_torch_decoder.py) and no attention mask flips."""
    IC, levels, mf_hw = 64, [(2, 3), (4, 6), (8, 12)], (16, 24)
    dec = _decisive(init_random(
        MeanShiftDecoder(hidden_dim=E, num_queries=Q, nheads=NH, dim_feedforward=FF,
                         dec_layers=3, mask_dim=MD, in_channels=IC, num_feature_levels=3),
        GEN(8))).eval()
    xs = []
    for h, w in levels:
        x = rng.randn(1, h, w, IC).astype(np.float32)
        xs.append(x)
    mf = rng.randn(1, *mf_hw, MD).astype(np.float32)
    with torch.no_grad():
        got = dec([torch.from_numpy(x) for x in xs], torch.from_numpy(mf),
                  materialize_masks=True)
    sd = {f"sem_seg_head.predictor.{k}": v.numpy() for k, v in dec.state_dict().items()}
    params = convert_msmformer_checkpoint(sd)["params"]["predictor"]
    jdec = JaxDecoder(hidden_dim=E, num_queries=Q, nheads=NH, dim_feedforward=FF, dec_layers=3,
                      mask_dim=MD, in_channels=IC, num_feature_levels=3)
    want = jax.jit(jdec.apply)({"params": params}, [jnp.asarray(x) for x in xs],
                               jnp.asarray(mf))
    for key in ("pred_logits", "mask_embed", "pred_masks"):
        w = np.asarray(want[key])
        atol = 1e-4 * max(1.0, float(np.abs(w).max()) / 10)
        np.testing.assert_allclose(got[key].numpy(), w, atol=atol, rtol=1e-5, err_msg=key)
    assert got["pred_masks"].shape == (1, Q, *mf_hw)
    for g, wnt in zip(got["aux_outputs"], want["aux_outputs"]):
        np.testing.assert_allclose(g["pred_logits"].numpy(), np.asarray(wnt["pred_logits"]),
                                   atol=1e-4, rtol=1e-5)


def test_three_level_decoder_refuses_key_stride():
    with pytest.raises(ValueError, match="1-level"):
        MeanShiftDecoder(num_feature_levels=3, key_stride=2)
