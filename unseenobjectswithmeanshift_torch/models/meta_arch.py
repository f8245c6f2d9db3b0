"""Meta-architectures: backbone -> pixel decoder -> mean-shift decoder.

Port of ``unseenobjectswithmeanshift_tpu.models.meta_arch``: MSMFormer, the
UCN-backbone arch (light path :65-125, the train forward :97-135,
SimplePixelDecoder :34; ref:
pretrained_meanshiftformer_model.py:50-497), and StandardMaskFormer, the
ResNet50 / Swin arch (:146-261), chosen by ``build_model``. The decoder's
cross-attention runs the CUDA kernel whenever its tensors are on a CUDA
device, with no flag that turns it off; on the CPU it runs the kernel's
plain version. Every module computes in ``cfg.dtype``
(``models/compute.py``): the backbone, the pixel decoder (the MSDeformAttn
one in fp32 when ``pixel_decoder.fp32``) and the decoder, whose outputs
come out in it.

Module names follow the published checkpoint layout:
``pretrained_backbone.*`` or ``backbone.*``, ``sem_seg_head.pixel_decoder.*``,
``sem_seg_head.predictor.*``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..config import COCO_PIXEL_MEAN_RGB, COCO_PIXEL_STD_RGB, Config
from ..ops.resize import resize_bilinear
from .backbone_resnet import ResNetBackbone
from .compute import Conv2d, compute_dtype
from .decoder import MeanShiftDecoder
from .pixel_decoders import build_pixel_decoder
from .segnet import build_segnet, l2_normalize
from .swin import SwinTransformer


class SimplePixelDecoder(nn.Module):
    """3x3 conv conv_dim -> mask_dim for the mask features (identity when the
    widths agree; ref: fpn.py SimpleBasePixelDecoder:161-290)."""

    def __init__(self, conv_dim: int = 64, mask_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mask_features = (Conv2d(conv_dim, mask_dim, 3, padding=1, compute_dtype=dtype)
                              if mask_dim != conv_dim else None)

    def forward(self, features):
        return features if self.mask_features is None else self.mask_features(features)


def build_decoder(cfg: Config, in_channels: int) -> MeanShiftDecoder:
    d = cfg.decoder
    # key_stride is an inference option: a train forward refuses > 1 (the
    # JAX package forces 1 in training, meta_arch.py:116)
    return MeanShiftDecoder(
        num_classes=d.num_classes, hidden_dim=d.hidden_dim,
        num_queries=d.num_queries, nheads=d.nheads,
        dim_feedforward=d.dim_feedforward, dec_layers=d.dec_layers,
        mask_dim=d.mask_dim, in_channels=in_channels, kappa=d.kappa,
        tile_skip=d.tile_skip, tile_skip_force_all=d.tile_skip_force_all,
        key_stride=d.key_stride, decoder_block_norm=d.decoder_block_norm,
        num_feature_levels=d.num_feature_levels, dtype=compute_dtype(cfg.dtype))


class _SemSegHead(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        dt = compute_dtype(cfg.dtype)
        self.pixel_decoder = SimplePixelDecoder(cfg.pixel_decoder.conv_dim,
                                                cfg.pixel_decoder.mask_dim, dt)
        self.predictor = build_decoder(cfg, cfg.decoder.conv_dim)


def is_standard(cfg: Config) -> bool:
    """The configuration selects the standard-backbone arch (ResNet50 or
    Swin), as the JAX package's build_model decides."""
    return cfg.use_other_backbone or cfg.backbone.kind != "ucn"


def check_supported(cfg: Config):
    """Raises ValueError for a configuration the port does not build, naming
    where its port is planned (ROADMAP queue 1 item 10) or why the JAX
    package cannot build it either."""
    d, b = cfg.decoder, cfg.backbone
    if (d.pre_norm or d.disable_attention_mask or not d.use_meanshift_cross_attention
            or not d.use_meanshift_self_attention):
        raise ValueError(f"preset {cfg.name!r}: only the post-norm mean-shift decoder with "
                         "attention masks is ported; pre_norm, disable_attention_mask and "
                         "softmax cross- or self-attention are not (ROADMAP queue 1 item 10)")
    if is_standard(cfg):
        if d.num_feature_levels != 3:
            raise ValueError(f"preset {cfg.name!r}: the standard-backbone arch feeds the "
                             f"decoder 3 pyramid levels, not decoder.num_feature_levels="
                             f"{d.num_feature_levels}; the JAX package cannot build this "
                             "either")
        return
    if cfg.pixel_decoder.name != "simple":
        raise ValueError(f"preset {cfg.name!r}: pixel_decoder.name {cfg.pixel_decoder.name!r} "
                         "requires the standard-backbone arch (backbone.kind resnet50|swin); "
                         "the JAX package cannot build it on the UCN backbone either")
    if d.num_feature_levels != 1:
        raise ValueError(f"preset {cfg.name!r}: the UCN backbone gives one feature map, not "
                         f"decoder.num_feature_levels={d.num_feature_levels}; the JAX package "
                         "cannot build this either")
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
        self.pretrained_backbone = build_segnet(cfg, grouped_towers=False)
        self.sem_seg_head = _SemSegHead(cfg)

    def features(self, image, xyz=None):
        """(features, mask_features), both NHWC: the SEGNET embedding
        L2-normalized once more by the meta-arch
        (pretrained_meanshiftformer_model.py:298) and the pixel decoder's
        mask features."""
        t = lambda x: None if x is None else x.permute(0, 3, 1, 2)
        features = l2_normalize(self.pretrained_backbone.forward_nchw(t(image), t(xyz)), dim=1)
        mask_features = self.sem_seg_head.pixel_decoder(features)
        return features.permute(0, 2, 3, 1), mask_features.permute(0, 2, 3, 1)

    def forward(self, image, xyz=None, light: bool = True, train: bool = False):
        """image, xyz: [B, H, W, 3] (normalized BGR, camera XYZ; xyz None for
        COLOR input), H and W padded to the size divisibility. light=True
        returns mask_embed [B, Q, Cm] and mask_features [B, H, W, Cm] instead
        of the [B, Q, H, W] masks.

        train=True is the JAX package's train forward (meta_arch.py:97-135):
        the decoder's unfused path (``forward_unfused``, every attention
        under ``torch.utils.checkpoint`` when ``train_remat_attention``), and
        the outputs add mask_features and backbone_features (the normalized
        embedding, for the embedding loss); the criterion scores the masks
        in factored form. BatchNorm follows the module's mode: call
        ``model.train()`` first for batch statistics."""
        features, mask_features = self.features(image, xyz)
        predictor = self.sem_seg_head.predictor
        if train:
            if predictor.key_stride != 1:
                raise ValueError("training runs at decoder.key_stride 1, as the JAX package "
                                 "forces it (meta_arch.py:116)")
            outputs = predictor.forward_unfused(features, mask_features,
                                                remat=self.cfg.train_remat_attention)
            outputs["mask_features"] = mask_features
            outputs["backbone_features"] = features
            return outputs
        outputs = predictor(features, mask_features, materialize_masks=not light)
        if light:
            outputs["mask_features"] = mask_features
        return outputs


class StandardMaskFormer(nn.Module):
    """Standard-backbone arch: {ResNet50 | Swin} -> {MSDeformAttn | FPN |
    transformer-encoder} pixel decoder -> 3-level mean-shift decoder (JAX
    ``StandardMaskFormer``, meta_arch.py:146-261; ref:
    meanshiftformer_model.py, configs/*_ResNet50.yaml). The COCO mean/std
    normalization runs first, on the image as the pipeline gives it (the
    reference's eval path feeds this model the UCN dataset's normalized-BGR
    tensor, JAX :160-169). ``xyz`` is accepted and ignored. Module names are
    the reference checkpoint's: ``backbone.*``,
    ``sem_seg_head.pixel_decoder.*``, ``sem_seg_head.predictor.*``."""

    def __init__(self, cfg: Config):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dt = compute_dtype(cfg.dtype)
        if cfg.backbone.kind == "swin":
            self.backbone = SwinTransformer(dtype=dt)
            channels = (96, 192, 384, 768)
        else:
            self.backbone = ResNetBackbone(dtype=dt)
            channels = (256, 512, 1024, 2048)
        self.sem_seg_head = nn.Module()
        self.sem_seg_head.pixel_decoder = build_pixel_decoder(cfg.pixel_decoder, channels, dt)
        self.sem_seg_head.predictor = build_decoder(cfg, cfg.pixel_decoder.conv_dim)

    def backbone_features(self, image):
        """The backbone's NCHW res2..res5 of the COCO-normalized image."""
        mean = torch.tensor(COCO_PIXEL_MEAN_RGB, dtype=torch.float32, device=image.device)
        std = torch.tensor(COCO_PIXEL_STD_RGB, dtype=torch.float32, device=image.device)
        x = ((image.float() - mean) / std).to(compute_dtype(self.cfg.dtype))
        return self.backbone(x.permute(0, 3, 1, 2))

    def forward(self, image, xyz=None, light: bool = True, train: bool = False):
        """image: [B, H, W, 3], H and W padded to the size divisibility.
        light=True returns mask_embed [B, Q, Cm] and the stride-4
        mask_features [B, H/4, W/4, Cm] (instance_inference upsamples only
        the selected masks); light=False returns pred_masks [B, Q, H, W],
        upsampled to the input (bilinear, align_corners=False, JAX
        :257-263).

        train=True is the JAX package's train forward (meta_arch.py:146-261
        with train=True): the decoder's unfused path (``forward_unfused``
        over the three levels, every attention under
        ``torch.utils.checkpoint`` when ``train_remat_attention``), and the
        outputs add the stride-4 mask_features; there is no
        backbone_features (no embedding head). The ResNet50's BatchNorm stays
        frozen in either mode (``FrozenBatchNorm2d``: buffers, no gradient;
        ROADMAP.md section 3 says where the JAX package differs)."""
        features = self.backbone_features(image)
        mask_features, _, multi_scale = self.sem_seg_head.pixel_decoder(features)
        levels = [m.permute(0, 2, 3, 1) for m in multi_scale]
        mask_features = mask_features.permute(0, 2, 3, 1)
        predictor = self.sem_seg_head.predictor
        if train:
            if predictor.key_stride != 1:
                raise ValueError("training runs at decoder.key_stride 1, as the JAX package "
                                 "forces it (meta_arch.py:235)")
            outputs = predictor.forward_unfused(levels, mask_features,
                                                remat=self.cfg.train_remat_attention)
            outputs["mask_features"] = mask_features
            return outputs
        outputs = predictor(levels, mask_features, materialize_masks=not light)
        if light:
            outputs["mask_features"] = mask_features
        elif tuple(outputs["pred_masks"].shape[-2:]) != tuple(image.shape[1:3]):
            outputs["pred_masks"] = resize_bilinear(outputs["pred_masks"][..., None],
                                                    image.shape[1:3])[..., 0]
        return outputs


def build_model(cfg: Config) -> nn.Module:
    """The meta-architecture of a configuration (JAX ``build_model``,
    meta_arch.py:262-271): StandardMaskFormer when it selects a standard
    backbone (use_other_backbone or backbone.kind), else MSMFormer."""
    return StandardMaskFormer(cfg) if is_standard(cfg) else MSMFormer(cfg)
