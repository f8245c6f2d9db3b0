"""MSMFormer meta-architecture: SEGNET backbone -> pixel decoder -> decoder.

Port of ``unseenobjectswithmeanshift_tpu.models.meta_arch`` (MSMFormer light
path :65-125, SimplePixelDecoder :34; ref:
pretrained_meanshiftformer_model.py:50-497). The decoder's cross-attention
runs the CUDA kernel whenever its tensors are on a CUDA device, with no flag
that turns it off; on the CPU it runs the kernel's plain version.

Module names follow the published checkpoint layout:
``pretrained_backbone.*``, ``sem_seg_head.pixel_decoder.mask_features``,
``sem_seg_head.predictor.*``.
"""

from __future__ import annotations

import torch.nn as nn

from ..config import Config
from .decoder import MeanShiftDecoder
from .segnet import build_segnet, l2_normalize


class SimplePixelDecoder(nn.Module):
    """3x3 conv conv_dim -> mask_dim for the mask features (identity when the
    widths agree; ref: fpn.py SimpleBasePixelDecoder:161-290)."""

    def __init__(self, conv_dim: int = 64, mask_dim: int = 256):
        super().__init__()
        self.mask_features = (nn.Conv2d(conv_dim, mask_dim, 3, padding=1)
                              if mask_dim != conv_dim else None)

    def forward(self, features):
        return features if self.mask_features is None else self.mask_features(features)


class _SemSegHead(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        d = cfg.decoder
        self.pixel_decoder = SimplePixelDecoder(cfg.pixel_decoder.conv_dim,
                                                cfg.pixel_decoder.mask_dim)
        # key_stride is an inference option: the port runs inference only
        # (the JAX package forces 1 in training, meta_arch.py:116)
        self.predictor = MeanShiftDecoder(
            num_classes=d.num_classes, hidden_dim=d.hidden_dim,
            num_queries=d.num_queries, nheads=d.nheads,
            dim_feedforward=d.dim_feedforward, dec_layers=d.dec_layers,
            mask_dim=d.mask_dim, in_channels=d.conv_dim, kappa=d.kappa,
            tile_skip=d.tile_skip, tile_skip_force_all=d.tile_skip_force_all,
            key_stride=d.key_stride, decoder_block_norm=d.decoder_block_norm)


def check_supported(cfg: Config):
    """Raises ValueError for a configuration the port's MSMFormer does not
    build, naming where its port is planned (ROADMAP queue 1) or why the JAX
    package cannot build it either."""
    d, b = cfg.decoder, cfg.backbone
    if cfg.pixel_decoder.name != "simple":
        raise ValueError(f"preset {cfg.name!r}: the {cfg.pixel_decoder.name!r} pixel decoder "
                         "belongs to the standard-backbone family, not ported (ROADMAP queue 1 "
                         "item 10)")
    if (d.num_feature_levels != 1 or d.pre_norm or d.disable_attention_mask
            or not d.use_meanshift_cross_attention or not d.use_meanshift_self_attention):
        raise ValueError(f"preset {cfg.name!r}: only the 1-level post-norm mean-shift decoder "
                         "with attention masks is ported (ROADMAP queue 1 item 10)")
    out = b.num_units * (2 if b.input_type == "RGBD" and b.fusion_type == "cat" else 1)
    if out != d.conv_dim or out != cfg.pixel_decoder.conv_dim:
        raise ValueError(f"preset {cfg.name!r}: the SEGNET gives {out} channels "
                         f"({b.input_type} {b.fusion_type}) but the decoder takes "
                         f"decoder.conv_dim={d.conv_dim}; the JAX package cannot build this "
                         "MSMFormer either (its input projection is [conv_dim, hidden_dim])")


class MSMFormer(nn.Module):
    """Whole-image or crop network of the UCN-backbone configuration."""

    def __init__(self, cfg: Config):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        # the JAX package's MSMFormer builds its SEGNET without grouped towers
        self.pretrained_backbone = build_segnet(cfg.backbone, grouped_towers=False)
        self.sem_seg_head = _SemSegHead(cfg)

    def forward(self, image, xyz=None, light: bool = True):
        """image, xyz: [B, H, W, 3] (normalized BGR, camera XYZ; xyz None for
        COLOR input), H and W padded to the size divisibility. light=True
        returns mask_embed [B, Q, Cm] and mask_features [B, H, W, Cm] instead
        of the [B, Q, H, W] masks."""
        t = lambda x: None if x is None else x.permute(0, 3, 1, 2)
        features = self.pretrained_backbone.forward_nchw(t(image), t(xyz))
        # the meta-arch re-normalizes (pretrained_meanshiftformer_model.py:298)
        features = l2_normalize(features, dim=1)
        mask_features = self.sem_seg_head.pixel_decoder(features)
        outputs = self.sem_seg_head.predictor(
            features.permute(0, 2, 3, 1), mask_features.permute(0, 2, 3, 1),
            materialize_masks=not light)
        if light:
            outputs["mask_features"] = mask_features.permute(0, 2, 3, 1)
        return outputs
