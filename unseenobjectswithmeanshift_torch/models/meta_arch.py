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
from .segnet import SEGNET, l2_normalize


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
        self.predictor = MeanShiftDecoder(
            num_classes=d.num_classes, hidden_dim=d.hidden_dim,
            num_queries=d.num_queries, nheads=d.nheads,
            dim_feedforward=d.dim_feedforward, dec_layers=d.dec_layers,
            mask_dim=d.mask_dim, in_channels=d.conv_dim, kappa=d.kappa,
            tile_skip=d.tile_skip, tile_skip_force_all=d.tile_skip_force_all)


class MSMFormer(nn.Module):
    """Whole-image or crop network of the UCN-backbone configuration."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.pretrained_backbone = SEGNET(cfg.backbone.num_units)
        self.sem_seg_head = _SemSegHead(cfg)

    def forward(self, image, xyz, light: bool = True):
        """image, xyz: [B, H, W, 3] (normalized BGR, camera XYZ), H and W
        padded to the size divisibility. light=True returns mask_embed
        [B, Q, Cm] and mask_features [B, H, W, Cm] instead of the [B, Q, H, W]
        masks."""
        t = lambda x: x.permute(0, 3, 1, 2)
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
