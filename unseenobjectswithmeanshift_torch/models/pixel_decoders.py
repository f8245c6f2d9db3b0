"""Pixel decoders of the standard-backbone (ResNet50 / Swin) configurations.

Port of ``unseenobjectswithmeanshift_tpu.models.pixel_decoders``:

- ``MSDeformAttnPixelDecoder`` (JAX :92-201; ref: msdeformattn.py:164-358):
  a deformable-attention encoder over res5, res4, res3 (1x1 projection +
  GroupNorm per level, sine positions + level embedding, reference points at
  the pixel centres), an FPN step that fuses res2 at stride 4 and a 1x1
  ``mask_features`` conv. ``compute_dtype`` is fp32 when
  ``pixel_decoder.fp32`` (the reference runs this decoder under
  ``autocast(enabled=False)``, msdeformattn.py:314), whatever the model's
  dtype; the outputs are cast to the model's dtype.
- ``BasePixelDecoder`` (JAX :32-71; ref: fpn.py:37-159): top-down FPN over
  res2..res5 with nearest upsampling and a 3x3 ``mask_features`` conv.
- ``TransformerEncoderPixelDecoder`` (JAX :204-286; ref: fpn.py:333-441):
  the FPN with a post-norm softmax transformer encoder on res5.

Each takes the backbone's NCHW feature dict and returns (mask_features,
transformer_features, multi_scale_features), NCHW, the multi-scale maps
from the lowest resolution up. Module names are the reference checkpoint's
(``input_proj.{i}.{0,1}``, ``transformer.level_embed``,
``transformer.encoder.layers.{i}.*``, ``adapter_{n}`` / ``layer_{n}`` with
their ``.norm``, ``mask_features``).

GroupNorm eps is 1e-5, the reference's (torch's default), which published
checkpoints were trained with; the JAX package leaves flax's 1e-6 there
(ROADMAP.md section 3).

The train forward is the eval forward (no dropout in either package). In a
bf16 model the MSDeformAttn decoder still computes in fp32 under
``pixel_decoder.fp32``, as the JAX module does (:136-146): its casts of
the bf16 backbone features in and of its outputs back are autograd ops, so
the gradient returns to the backbone in bf16.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.hypersphere_attention import merge_heads, split_heads
from ..ops.ms_deform_attn import MSDeformAttn
from ..ops.resize import resize_nearest
from .compute import Conv2d, GroupNorm, LayerNorm, Linear
from .position_encoding import position_embedding_sine

GN_GROUPS = 32


def _pos_nchw(x, num_pos_feats: int):
    """[1, 2 F, h, w] sine positions of x's grid (fp32)."""
    h, w = x.shape[-2:]
    return position_embedding_sine(h, w, num_pos_feats, device=x.device).permute(2, 0, 1)[None]


class ConvGN(Conv2d):
    """detectron2's Conv2d with an attached GroupNorm ``norm`` and an
    optional relu (bias off, as the reference's convs with a norm)."""

    def __init__(self, cin, cout, k, relu: bool, dtype=torch.float32):
        super().__init__(cin, cout, k, padding=k // 2, bias=False, compute_dtype=dtype)
        self.norm = GroupNorm(GN_GROUPS, cout)
        self.relu = relu

    def forward(self, x):
        y = self.norm(super().forward(x))
        return F.relu(y) if self.relu else y


class MSDeformAttnEncoderLayer(nn.Module):
    """(ref: msdeformattn.py:94-131; no dropout)"""

    def __init__(self, d_model=256, d_ffn=1024, n_levels=3, n_heads=8, n_points=4,
                 dtype=torch.float32):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points, dtype)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = Linear(d_model, d_ffn, compute_dtype=dtype)
        self.linear2 = Linear(d_ffn, d_model, compute_dtype=dtype)
        self.norm2 = LayerNorm(d_model)

    def forward(self, src, pos, reference_points, spatial_shapes):
        src = self.norm1(src + self.self_attn(src + pos, reference_points, src, spatial_shapes))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


def encoder_reference_points(spatial_shapes, n_levels: int, device):
    """[1, Len, n_levels, 2] pixel centres (x, y) normalized by each level's
    size, the same point for every level (ref: get_reference_points with all
    valid ratios 1: inference never pads)."""
    pts = []
    for h, w in spatial_shapes:
        ry = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        rx = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        pts.append(torch.stack([rx[None, :].expand(h, w), ry[:, None].expand(h, w)],
                               -1).reshape(-1, 2))
    ref = torch.cat(pts)
    return ref[None, :, None, :].expand(1, ref.shape[0], n_levels, 2)


class _EncoderOnly(nn.Module):
    def __init__(self, d_model, n_levels, layers, **kw):
        super().__init__()
        self.level_embed = nn.Parameter(torch.empty(n_levels, d_model))
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            MSDeformAttnEncoderLayer(d_model, n_levels=n_levels, **kw) for _ in range(layers))


class MSDeformAttnPixelDecoder(nn.Module):
    def __init__(self, feature_channels=(256, 512, 1024, 2048), conv_dim=256, mask_dim=256,
                 nheads=8, dim_feedforward=1024, enc_layers=6, n_points=4, num_outputs=3,
                 dtype=torch.float32, compute_dtype=torch.float32):
        super().__init__()
        self.dtype, self.cdt, self.num_outputs = dtype, compute_dtype, num_outputs
        # encoder levels res5, res4, res3 (index 0 = lowest resolution)
        self.in_features = ("res5", "res4", "res3")
        cdt = compute_dtype
        self.input_proj = nn.ModuleList(
            nn.Sequential(Conv2d(c, conv_dim, 1, compute_dtype=cdt), GroupNorm(GN_GROUPS, conv_dim))
            for c in feature_channels[1:][::-1])
        self.transformer = _EncoderOnly(conv_dim, len(self.in_features), enc_layers,
                                        d_ffn=dim_feedforward, n_heads=nheads,
                                        n_points=n_points, dtype=cdt)
        self.mask_features = Conv2d(conv_dim, mask_dim, 1, compute_dtype=cdt)
        self.adapter_1 = ConvGN(feature_channels[0], conv_dim, 1, relu=False, dtype=cdt)
        self.layer_1 = ConvGN(conv_dim, conv_dim, 3, relu=True, dtype=cdt)

    def forward(self, features: Dict[str, torch.Tensor]):
        cdt, C = self.cdt, self.transformer.level_embed.shape[1]
        srcs, poss, shapes = [], [], []
        for lvl, f in enumerate(self.in_features):
            x = self.input_proj[lvl](features[f].to(cdt))
            B, _, h, w = x.shape
            shapes.append((h, w))
            pos = _pos_nchw(x, C // 2).to(cdt) + self.transformer.level_embed[lvl].to(cdt)[
                None, :, None, None]
            srcs.append(x.flatten(2).transpose(1, 2))
            poss.append(pos.flatten(2).transpose(1, 2).expand(B, -1, -1))
        src, pos = torch.cat(srcs, 1), torch.cat(poss, 1)
        ref = encoder_reference_points(shapes, len(shapes), src.device)
        for layer in self.transformer.encoder.layers:
            src = layer(src, pos, ref, shapes)
        out, start = [], 0
        for h, w in shapes:
            out.append(src[:, start:start + h * w].transpose(1, 2).reshape(B, C, h, w))
            start += h * w
        x = features["res2"].to(cdt)
        lat = self.adapter_1(x)
        y = lat + F.interpolate(out[-1], size=lat.shape[-2:], mode="bilinear",
                                align_corners=False)
        out.append(self.layer_1(y))
        dt = self.dtype
        return (self.mask_features(out[-1]).to(dt), out[0].to(dt),
                [m.to(dt) for m in out[:self.num_outputs]])


class _FPN(nn.Module):
    """The top-down FPN of BasePixelDecoder: ``adapter_{n}`` / ``layer_{n}``
    with n = 1 for res2 up to len(features) for res5 (the reference's
    numbering; res5 has no adapter)."""

    def _build_fpn(self, feature_channels, conv_dim, mask_dim, top_in, dtype):
        n = len(feature_channels)
        for i, c in enumerate(feature_channels[:-1]):
            setattr(self, f"adapter_{i + 1}", ConvGN(c, conv_dim, 1, relu=False, dtype=dtype))
            setattr(self, f"layer_{i + 1}", ConvGN(conv_dim, conv_dim, 3, relu=True, dtype=dtype))
        setattr(self, f"layer_{n}", ConvGN(top_in, conv_dim, 3, relu=True, dtype=dtype))
        self.mask_features = Conv2d(conv_dim, mask_dim, 3, padding=1, compute_dtype=dtype)
        self.n = n

    def _top_down(self, features, top):
        names = [f"res{i + 2}" for i in range(self.n)]
        y = getattr(self, f"layer_{self.n}")(top)
        multi_scale = [y]
        for i in range(self.n - 1, 0, -1):
            x = features[names[i - 1]]
            lat = getattr(self, f"adapter_{i}")(x)
            y = lat + resize_nearest(y.permute(0, 2, 3, 1), lat.shape[-2:]).permute(0, 3, 1, 2)
            y = getattr(self, f"layer_{i}")(y)
            if len(multi_scale) < self.num_outputs:
                multi_scale.append(y)
        return self.mask_features(y), multi_scale


class BasePixelDecoder(_FPN):
    def __init__(self, feature_channels=(256, 512, 1024, 2048), conv_dim=256, mask_dim=256,
                 num_outputs=3, dtype=torch.float32):
        super().__init__()
        self.num_outputs = num_outputs
        self._build_fpn(feature_channels, conv_dim, mask_dim, feature_channels[-1], dtype)

    def forward(self, features):
        mf, ms = self._top_down(features, features[f"res{self.n + 1}"])
        return mf, None, ms


class SoftmaxAttention(nn.Module):
    """Multi-head softmax attention with nn.MultiheadAttention's parameter
    names (``in_proj_weight`` [3E, E], ``in_proj_bias``, ``out_proj``); the
    logits scaled by 1/sqrt(D), the softmax in fp32."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query, key, value):
        dt = query.dtype
        wq, wk, wv = self.in_proj_weight.to(dt).chunk(3)
        bq, bk, bv = self.in_proj_bias.to(dt).chunk(3)
        q, k, v = (split_heads(F.linear(x, w_, b_), self.num_heads)
                   for x, w_, b_ in ((query, wq, bq), (key, wk, bk), (value, wv, bv)))
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / (q.shape[-1] ** 0.5)
        attn = logits.float().softmax(-1).to(dt)
        out = merge_heads(torch.einsum("bhqk,bhkd->bhqd", attn, v))
        return F.linear(out, self.out_proj.weight.to(dt), self.out_proj.bias.to(dt))


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer (ref: transformer.py TransformerEncoderLayer;
    no dropout)."""

    def __init__(self, d_model=256, nheads=8, dim_feedforward=2048, dtype=torch.float32):
        super().__init__()
        self.self_attn = SoftmaxAttention(d_model, nheads)
        self.linear1 = Linear(d_model, dim_feedforward, compute_dtype=dtype)
        self.linear2 = Linear(dim_feedforward, d_model, compute_dtype=dtype)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, src, pos):
        qk = src + pos
        src = self.norm1(src + self.self_attn(qk, qk, src))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class TransformerEncoderPixelDecoder(_FPN):
    def __init__(self, feature_channels=(256, 512, 1024, 2048), conv_dim=256, mask_dim=256,
                 enc_layers=6, nheads=8, dim_feedforward=2048, num_outputs=3,
                 dtype=torch.float32):
        super().__init__()
        self.num_outputs = num_outputs
        self.input_proj = Conv2d(feature_channels[-1], conv_dim, 1, compute_dtype=dtype)
        self.transformer = nn.Module()
        self.transformer.encoder = nn.Module()
        self.transformer.encoder.layers = nn.ModuleList(
            TransformerEncoderLayer(conv_dim, nheads, dim_feedforward, dtype)
            for _ in range(enc_layers))
        self._build_fpn(feature_channels, conv_dim, mask_dim, conv_dim, dtype)

    def forward(self, features):
        x = self.input_proj(features[f"res{self.n + 1}"])
        B, C, h, w = x.shape
        pos = _pos_nchw(x, C // 2).to(x.dtype).flatten(2).transpose(1, 2)
        src = x.flatten(2).transpose(1, 2)
        for layer in self.transformer.encoder.layers:
            src = layer(src, pos)
        tf = src.transpose(1, 2).reshape(B, C, h, w)
        mf, ms = self._top_down(features, tf)
        return mf, tf, ms


def build_pixel_decoder(pd, feature_channels, dtype) -> nn.Module:
    """The pixel decoder that ``pixel_decoder.name`` selects (fpn |
    transformer_enc | msdeformattn); raises ValueError on any other."""
    if pd.name == "msdeformattn":
        return MSDeformAttnPixelDecoder(
            feature_channels, pd.conv_dim, pd.mask_dim, enc_layers=pd.transformer_enc_layers,
            dtype=dtype, compute_dtype=torch.float32 if pd.fp32 else dtype)
    if pd.name == "fpn":
        return BasePixelDecoder(feature_channels, pd.conv_dim, pd.mask_dim, dtype=dtype)
    if pd.name == "transformer_enc":
        return TransformerEncoderPixelDecoder(feature_channels, pd.conv_dim, pd.mask_dim,
                                              enc_layers=pd.transformer_enc_layers, dtype=dtype)
    raise ValueError(f"unknown pixel_decoder.name {pd.name!r} for the standard-backbone arch "
                     "(fpn | transformer_enc | msdeformattn)")

