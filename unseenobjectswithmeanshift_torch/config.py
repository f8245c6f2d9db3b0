"""Configuration dataclasses and the two presets of the two-stage main path.

An independent copy of the fields of ``unseenobjectswithmeanshift_tpu.config``
that the two-stage MSMFormer and UCN inference read. Defaults mirror the shipped
flagship configuration (ref: MSMFormer/configs/tabletop_pretrained.yaml and
crop_tabletop_pretrained.yaml; UCN RGB-D ResNet34-8s backbone).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class BackboneConfig:
    """UCN SEGNET backbone: RGB and XYZ ResNet34-8s towers, 'add' fusion
    (ref: lib/networks/SEG.py:26-126)."""

    num_units: int = 64               # embedding dim


@dataclass
class DecoderConfig:
    """MSMFormer mean-shift transformer decoder (1 feature level)."""

    hidden_dim: int = 256
    num_queries: int = 100
    nheads: int = 8
    dim_feedforward: int = 2048
    dec_layers: int = 6
    mask_dim: int = 256
    conv_dim: int = 64                # channels of the backbone feature map
    num_classes: int = 2
    kappa: float = 30.0
    # skip the 64-key tiles of the cross-attention where no query of an image
    # has an unmasked key (exact: same output bits); pays off only where the
    # masks concentrate, as with trained weights
    tile_skip: bool = False
    # control: the tile-skipping kernel with every tile present
    tile_skip_force_all: bool = False


@dataclass
class PixelDecoderConfig:
    """SimpleBasePixelDecoder: one 3x3 conv conv_dim -> mask_dim."""

    conv_dim: int = 64
    mask_dim: int = 256


@dataclass
class TestConfig:
    """Inference knobs (ref: tabletop_pretrained.yaml TEST, lib/fcn/test_utils.py)."""

    topk: bool = True
    confident_score: float = 0.9
    low_threshold: float = 0.4
    max_instances: int = 20
    crop_size: int = 224
    crop_padding: float = 0.25
    depth_filter_threshold_ocid: float = 0.5
    depth_filter_threshold_osd: float = 0.8
    overlap_match_threshold: float = 0.5


@dataclass
class MeanShiftConfig:
    """Non-learned vMF mean-shift clustering of the UCN path
    (ref: lib/utils/mean_shift.py; knobs from lib/fcn/test_dataset.py:44-59).
    On a CUDA tensor the seeding always runs on the farthest-point kernel
    (``csrc/fps_seeds.cu``); ``use_pallas`` (the JAX package's name, so that
    its configurations read across) also puts the hill climbing on the fused
    kernel (``csrc/mean_shift_climb.cu``)."""

    kappa: float = 20.0
    num_seeds: int = 100
    max_iters: int = 10
    epsilon: float = 0.04             # 2 * cfg.TRAIN.EMBEDDING_ALPHA (mean_shift.py:123)
    use_pallas: bool = False


@dataclass
class Config:
    name: str = "tabletop_pretrained"
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    pixel_decoder: PixelDecoderConfig = field(default_factory=PixelDecoderConfig)
    test: TestConfig = field(default_factory=TestConfig)
    mean_shift: MeanShiftConfig = field(default_factory=MeanShiftConfig)


def tabletop_pretrained() -> Config:
    """Whole-image network (ref: MSMFormer/configs/tabletop_pretrained.yaml)."""
    return Config()


def crop_tabletop_pretrained() -> Config:
    """Crop network: same architecture, crop-trained weights
    (ref: MSMFormer/configs/crop_tabletop_pretrained.yaml)."""
    return Config(name="crop_tabletop_pretrained")


PRESETS = {
    "tabletop_pretrained": tabletop_pretrained,
    "crop_tabletop_pretrained": crop_tabletop_pretrained,
}


def get_config(name: str = "tabletop_pretrained") -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]()
