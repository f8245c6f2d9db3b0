"""Configuration dataclasses, YAML loading and the presets.

An independent copy of ``unseenobjectswithmeanshift_tpu.config``: every field
and every preset, training fields included, so that a configuration reads
the same in both packages (``get_config(name)`` equals the JAX package's
field for field). Field defaults mirror the shipped flagship configuration
(ref: MSMFormer/configs/tabletop_pretrained.yaml,
configs/crop_tabletop_pretrained.yaml,
experiments/cfgs/seg_resnet34_8s_embedding_cosine_rgbd_add_tabletop.yml).

The port serves the UCN-backbone presets (``backbone.kind == "ucn"``); the
ResNet50 and Swin presets are data here, and the factories refuse to build
them. PyYAML is imported inside ``load_config`` only: the card machine has
none, and ``chip_smoke.py`` imports this module.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# BGR pixel means / 255, matching lib/fcn/config.py:377 (PIXEL_MEANS, BGR order)
# and lib/fcn/get_network_crop.py:146-148 (im/255 - mean/255).
UCN_PIXEL_MEANS_BGR = (102.9801, 115.9465, 122.7717)
# COCO RGB normalization used by the Detectron2-format datasets in COLOR mode
# (ref: lib/datasets/tabletop_dataset.py:395-396).
COCO_PIXEL_MEAN_RGB = (123.675, 116.280, 103.530)
COCO_PIXEL_STD_RGB = (58.395, 57.120, 57.375)


@dataclass
class BackboneConfig:
    """Backbone selection.

    kind picks the meta-architecture family (ref: META_ARCHITECTURE registry,
    lib/fcn/test_demo.py:48-72):
      - "ucn":      SEGNET embedding backbone + PretrainedMeanShiftMaskFormer
      - "resnet50": detectron2-style R50 + MeanShiftMaskFormer
                    (configs/UOAIS_ResNet50.yaml:49)
      - "swin":     D2SwinTransformer + MeanShiftMaskFormer (registered backbone,
                    modeling/backbone/swin.py:770 - no shipped config uses it)
    The remaining fields configure the UCN SEGNET (ref: lib/networks/SEG.py:26-126).
    """

    kind: str = "ucn"                 # ucn | resnet50 | swin
    network: str = "resnet34_8s"     # resnet34_8s | resnet50_8s | unet | vgg
    input_type: str = "RGBD"          # COLOR | DEPTH | RGBD
    fusion_type: str = "add"          # early | add | cat   (SEG.py:97-110)
    num_units: int = 64               # embedding dim (cfg.TRAIN.NUM_UNITS)
    normalize: bool = True            # L2-normalize output (SEG.py:112-114)
    output_stride: int = 8
    # run the two RGBD towers as ONE feature_group_count=2 conv stack
    # (numerically identical, doubles every conv's contraction width; see
    # models/segnet.SEGNET.grouped_towers + utils/checkpoint.fuse_tower_params)
    grouped_towers: bool = False


@dataclass
class DecoderConfig:
    """MSMFormer transformer decoder
    (ref: meanshiftformer_transformer_decoder.py:697-1048 and config.py MASK_FORMER.*)."""

    hidden_dim: int = 256
    num_queries: int = 100
    nheads: int = 8
    dim_feedforward: int = 2048
    dec_layers: int = 6               # cfg DEC_LAYERS - 1 (7 - 1)
    pre_norm: bool = False
    enforce_input_project: bool = False
    mask_dim: int = 256               # SEM_SEG_HEAD.MASK_DIM
    conv_dim: int = 64                # SEM_SEG_HEAD.CONVS_DIM (input feature channels)
    num_classes: int = 2              # SEM_SEG_HEAD.NUM_CLASSES
    num_feature_levels: int = 1       # 1 for Pretrained..., 3 for MeanShiftTransformerDecoder
    use_meanshift_cross_attention: bool = True
    use_meanshift_self_attention: bool = True
    disable_attention_mask: bool = False
    decoder_block_norm: bool = True
    kappa: float = 30.0               # attention_util.py:26 KAPPA
    use_pallas_attention: bool = True  # fused flash kernel for masked cross-attn (TPU only)
    # OPT-IN inference speedup, NOT the parity configuration (default 1 = off):
    # subsample the cross-attention KEYS by this stride. The UCN backbone's
    # feature map is bilinear-upsampled from stride 8 (resnet_dilated.py), so
    # neighboring keys are interpolates of the same stride-8 grid and a s<=4
    # subsample removes little information; masks stay full-resolution
    # (mask_features is not strided). Inference-only; training forces 1.
    key_stride: int = 1
    # EXACT inference speedup (bit-identical output, safe to enable): elide
    # attention K tiles certified all-masked for every query by a sound
    # interval bound on the mask logits (ops/fused_cross_attention.TilePlan).
    # Saves time proportional to mask concentration - trained weights
    # concentrate, random weights skip ~nothing. Fused-Pallas inference only.
    tile_skip: bool = False
    # control-experiment switch: tile_skip graph with the plan forced
    # all-present (zero tiles skipped) - see plan_tile_skip(force_all=True)
    tile_skip_force_all: bool = False


@dataclass
class PixelDecoderConfig:
    """Pixel decoder selection (ref: modeling/pixel_decoder/fpn.py, msdeformattn.py)."""

    name: str = "simple"              # simple | fpn | msdeformattn
    conv_dim: int = 64                # for simple: channels of the UCN feature map
    mask_dim: int = 256
    transformer_enc_layers: int = 6   # for msdeformattn
    common_stride: int = 4
    norm: str = "GN"
    fp32: bool = True                 # msdeformattn: the reference runs the
    # whole pixel decoder under autocast(enabled=False) (msdeformattn.py:314)
    # - fp32 is the PARITY setting. False = opt-in bf16 fast serving (follows
    # the model compute dtype), NOT the parity configuration.


@dataclass
class TestConfig:
    """Inference-time knobs (ref: tabletop_pretrained.yaml TEST / MASK_FORMER.TEST,
    lib/fcn/test_utils.py defaults)."""

    detections_per_image: int = 20    # TEST.DETECTIONS_PER_IMAGE
    topk: bool = True                 # get_confident_instances(topk=...) in test_dataset_crop
    confident_score: float = 0.9      # score threshold when topk=False
    low_threshold: float = 0.4        # class-score threshold when topk=True
    size_divisibility: int = 32       # MASK_FORMER.SIZE_DIVISIBILITY
    max_instances: int = 20           # static bound for two-stage refinement
    crop_size: int = 224              # cfg.TRAIN.SYN_CROP_SIZE
    crop_padding: float = 0.25        # crop_rois padding_percentage (test_dataset.py:66)
    depth_filter_threshold_ocid: float = 0.5   # test_utils.py:296-299
    depth_filter_threshold_osd: float = 0.8
    overlap_match_threshold: float = 0.5       # match_label_crop (test_dataset.py:124)
    use_nms: bool = False             # test_utils.py:30 USE_NMS
    nms_threshold: float = 0.7


@dataclass
class MeanShiftConfig:
    """Non-learned vMF mean-shift clustering for the UCN path
    (ref: lib/utils/mean_shift.py; knobs from lib/fcn/test_dataset.py:44-59)."""

    kappa: float = 20.0
    num_seeds: int = 100
    max_iters: int = 10
    epsilon: float = 0.04             # 2 * cfg.TRAIN.EMBEDDING_ALPHA (mean_shift.py:123)
    metric: str = "cosine"
    # The JAX package's names, kept so that configurations read across. In
    # the port, on a CUDA tensor the seeding always runs on the farthest-point
    # kernel (csrc/fps_seeds.cu) and use_pallas also puts the hill climbing
    # on the fused kernel (csrc/mean_shift_climb.cu); use_pallas_seeding is
    # read by the JAX package only.
    use_pallas: bool = False
    use_pallas_seeding: bool = True


@dataclass
class LossConfig:
    """Training losses (ref: pretrained_meanshiftformer_model.py:166-203,
    modeling/criterion.py, lib/networks/embedding.py)."""

    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    no_object_weight: float = 0.1
    deep_supervision: bool = True
    train_num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    # embedding (metric-learning) loss, for UCN backbone training
    use_embedding_loss: bool = False
    embedding_loss_weight: float = 1.0
    embedding_alpha: float = 0.02
    embedding_delta: float = 0.5
    embedding_lambda_intra: float = 1.0
    embedding_lambda_inter: float = 1.0
    embedding_metric: str = "cosine"
    embedding_normalize: bool = True
    max_gt_instances: int = 24        # static padding bound for Hungarian matching


@dataclass
class SolverConfig:
    """Optimizer (ref: tabletop_train_net_pretrained.py:112-191,
    Base-COCO-InstanceSegmentation.yaml SOLVER)."""

    optimizer: str = "adamw"
    base_lr: float = 1e-4
    weight_decay: float = 0.05
    weight_decay_norm: float = 0.0
    weight_decay_embed: float = 0.0
    backbone_multiplier: float = 0.1
    clip_gradients: float = 0.01      # full-model clip norm
    warmup_iters: int = 10            # SOLVER.WARMUP_ITERS (Base-COCO...yaml:25)
    warmup_factor: float = 1.0        # SOLVER.WARMUP_FACTOR (:24) - 1.0 = no-op,
    # matching every shipped reference config (detectron2 semantics)
    max_iter: int = 71000
    ims_per_batch: int = 4
    checkpoint_period: int = 17500
    # UCN backbone training (experiments/cfgs/*.yml)
    ucn_lr: float = 1e-5
    ucn_momentum: float = 0.9
    ucn_weight_decay: float = 1e-4
    ucn_epochs: int = 16
    ucn_batch_size: int = 16


@dataclass
class Config:
    """Top-level configuration."""

    name: str = "tabletop_pretrained"
    dataset_train: str = "tabletop_object"   # DATASETS.TRAIN registry name
    train_syn_crop: bool = False      # TRAIN.SYN_CROP (crop-network training)
    input: str = "RGBD"               # COLOR | DEPTH | RGBD (cfg.INPUT)
    pixel_means_bgr: Tuple[float, float, float] = UCN_PIXEL_MEANS_BGR
    use_depth: bool = True            # MODEL.USE_DEPTH
    use_other_backbone: bool = False  # MODEL.USE_OTHER_BACKBONE (ResNet50 config)
    dtype: str = "float32"            # compute dtype: float32 | bfloat16
    train_remat_attention: bool = True  # checkpoint decoder attention modules in
    # training (recompute in backward; the chunked large-K path checkpoints its
    # own scan body regardless)
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    pixel_decoder: PixelDecoderConfig = field(default_factory=PixelDecoderConfig)
    test: TestConfig = field(default_factory=TestConfig)
    mean_shift: MeanShiftConfig = field(default_factory=MeanShiftConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


def _update_dataclass(obj, updates: Dict[str, Any]):
    for k, v in updates.items():
        if not hasattr(obj, k):
            raise KeyError(f"unknown config key: {k!r} on {type(obj).__name__}")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _update_dataclass(cur, v)
        else:
            setattr(obj, k, tuple(v) if isinstance(cur, tuple) else v)


def load_config(path_or_dict, base: Optional[Config] = None) -> Config:
    """Build a Config from a YAML file path or a nested dict of overrides."""
    cfg = dataclasses.replace(base) if base is not None else Config()
    if isinstance(path_or_dict, str):
        import yaml

        with open(path_or_dict) as f:
            data = yaml.safe_load(f) or {}
    else:
        data = dict(path_or_dict)
    base_path = data.pop("_base_", None)
    if base_path is not None:
        cfg = load_config(base_path, base=cfg)
    _update_dataclass(cfg, data)
    return cfg


# ---------------------------------------------------------------------------
# Presets (mirroring the shipped reference configs)
# ---------------------------------------------------------------------------

def tabletop_pretrained() -> Config:
    """Flagship: UCN RGBD backbone + SimpleBasePixelDecoder + 1-level decoder
    (ref: MSMFormer/configs/tabletop_pretrained.yaml)."""
    return Config()


def crop_tabletop_pretrained() -> Config:
    """Second-stage crop network config (ref: configs/crop_tabletop_pretrained.yaml:
    same architecture, crop-trained weights, feature_crop backbone)."""
    cfg = Config(name="crop_tabletop_pretrained")
    return cfg


def tabletop_pretrained_rgb() -> Config:
    cfg = Config(name="tabletop_pretrained_rgb", input="COLOR", use_depth=False)
    cfg.backbone.input_type = "COLOR"
    return cfg


def _resnet50_base(name: str) -> Config:
    """Shared shape of every *_ResNet50 config: detectron2 R50 backbone,
    MSDeformAttnPixelDecoder with CONVS_DIM 64 / MASK_DIM 256, 3-level
    MeanShiftTransformerDecoder with DEC_LAYERS 10 (= 9 decoder layers),
    COLOR input (ref: configs/tabletop_pretrained_ResNet50.yaml,
    UOAIS_ResNet50.yaml, mixture_ResNet50.yaml, pushing_ResNet50.yaml)."""
    cfg = Config(name=name, use_other_backbone=True, use_depth=False,
                 input="COLOR")
    cfg.backbone.kind = "resnet50"
    cfg.pixel_decoder = PixelDecoderConfig(name="msdeformattn", conv_dim=64,
                                           mask_dim=256)
    cfg.decoder.num_feature_levels = 3
    cfg.decoder.conv_dim = 64
    cfg.decoder.dec_layers = 9        # DEC_LAYERS: 10 = 1 + 9
    return cfg


def uoais_resnet50() -> Config:
    """ref: MSMFormer/configs/UOAIS_ResNet50.yaml (DETECTIONS_PER_IMAGE 40)."""
    cfg = _resnet50_base("uoais_resnet50")
    cfg.dataset_train = "uoais_object"
    cfg.test.detections_per_image = 40
    cfg.test.max_instances = 40
    cfg.solver.max_iter = 90100        # UOAIS_ResNet50.yaml:6
    cfg.solver.checkpoint_period = 5624  # :7
    return cfg


def uoais_ucn() -> Config:
    """ref: MSMFormer/configs/UOAIS_UCN.yaml: UCN-backbone arch with
    DETECTIONS_PER_IMAGE 40 (:77) and 90k iterations."""
    cfg = Config(name="uoais_ucn")
    cfg.dataset_train = "uoais_object"
    cfg.test.detections_per_image = 40
    cfg.test.max_instances = 40
    cfg.solver.max_iter = 90000        # UOAIS_UCN.yaml:6
    cfg.solver.checkpoint_period = 5624  # :7
    return cfg


def tabletop_pretrained_resnet50() -> Config:
    """ref: configs/tabletop_pretrained_ResNet50.yaml."""
    return _resnet50_base("tabletop_pretrained_resnet50")


def crop_tabletop_resnet50_rgb() -> Config:
    """ref: configs/crop_tabletop_ResNet50_RGB.yaml (FEATURE_CROP stage-2)."""
    cfg = _resnet50_base("crop_tabletop_resnet50_rgb")
    cfg.solver.checkpoint_period = 8750
    return cfg


def tabletop_swin() -> Config:
    """Swin-T backbone variant of the standard-backbone arch. The reference
    registers D2SwinTransformer as a selectable backbone (modeling/backbone/
    swin.py:770) but ships no config for it; this preset makes the registered
    option runnable (Swin-T + MSDeformAttnPixelDecoder + 3-level decoder)."""
    cfg = _resnet50_base("tabletop_swin")
    cfg.backbone.kind = "swin"
    return cfg


def mixture_ucn() -> Config:
    """ref: configs/mixture_UCN.yaml: flagship arch fine-tuned on the 1:3
    pushing:tabletop mixture for 2120 iterations (RSS'23 self-supervision)."""
    cfg = Config(name="mixture_ucn")
    cfg.dataset_train = "mixture_object"
    cfg.solver.max_iter = 2120
    cfg.solver.checkpoint_period = 1060
    return cfg


def crop_mixture_ucn() -> Config:
    """ref: configs/crop_mixture_UCN.yaml."""
    cfg = mixture_ucn()
    cfg.name = "crop_mixture_ucn"
    return cfg


def mixture_resnet50() -> Config:
    """ref: configs/mixture_ResNet50.yaml."""
    cfg = _resnet50_base("mixture_resnet50")
    cfg.dataset_train = "mixture_object"
    return cfg


def crop_mixture_resnet50() -> Config:
    """ref: configs/crop_mixture_ResNet50.yaml (MAX_ITER 1000 - a short
    crop-network fine-tune, not the full 71k schedule)."""
    cfg = _resnet50_base("crop_mixture_resnet50")
    cfg.name = "crop_mixture_resnet50"
    cfg.dataset_train = "mixture_object"
    cfg.solver.max_iter = 1000          # crop_mixture_ResNet50.yaml:15
    cfg.solver.checkpoint_period = 160  # :16
    return cfg


def pushing_ucn() -> Config:
    """ref: configs/pushing_UCN.yaml (USE_DEPTH true, 2120 iters)."""
    cfg = Config(name="pushing_ucn")
    cfg.dataset_train = "pushing_object"
    cfg.solver.max_iter = 2120
    cfg.solver.checkpoint_period = 1060
    return cfg


def pushing_resnet50() -> Config:
    """ref: configs/pushing_ResNet50.yaml (USE_DEPTH true, R50 arch)."""
    cfg = _resnet50_base("pushing_resnet50")
    cfg.dataset_train = "pushing_object"
    cfg.use_depth = True
    cfg.input = "RGBD"
    return cfg


def _ucn_experiment(input_type: str, fusion_type: str, crop: bool) -> Config:
    """UCN training configs (ref: experiments/cfgs/seg_resnet34_8s_embedding_
    cosine_{color,depth,rgbd_add,rgbd_cat,rgbd_early}[_crop]_tabletop.yml):
    SGD lr 1e-5 batch 16, chromatic+noise aug, EMBEDDING lambdas 10.0,
    1000-px sampling; the _crop variants train the zoom-in network on
    SYN_CROP 224x224 object crops."""
    name = f"ucn_{input_type.lower()}{'_' + fusion_type if input_type == 'RGBD' else ''}"
    if crop:
        name += "_crop"
    cfg = Config(name=name, input=input_type, use_depth=input_type != "COLOR")
    cfg.backbone.input_type = input_type
    cfg.backbone.fusion_type = fusion_type
    cfg.loss.use_embedding_loss = True
    cfg.loss.embedding_lambda_intra = 10.0
    cfg.loss.embedding_lambda_inter = 10.0
    cfg.train_syn_crop = crop
    return cfg


PRESETS = {
    "tabletop_pretrained": tabletop_pretrained,
    "crop_tabletop_pretrained": crop_tabletop_pretrained,
    "tabletop_pretrained_rgb": tabletop_pretrained_rgb,
    "tabletop_pretrained_resnet50": tabletop_pretrained_resnet50,
    "tabletop_swin": tabletop_swin,
    "crop_tabletop_resnet50_rgb": crop_tabletop_resnet50_rgb,
    "uoais_resnet50": uoais_resnet50,
    "uoais_ucn": uoais_ucn,
    "mixture_ucn": mixture_ucn,
    "crop_mixture_ucn": crop_mixture_ucn,
    "mixture_resnet50": mixture_resnet50,
    "crop_mixture_resnet50": crop_mixture_resnet50,
    "pushing_ucn": pushing_ucn,
    "pushing_resnet50": pushing_resnet50,
}

# UCN experiment matrix (ref: experiments/cfgs/*.yml - 5 input modes x
# {whole, crop})
for _inp, _fus in (("COLOR", "add"), ("DEPTH", "add"), ("RGBD", "add"),
                   ("RGBD", "cat"), ("RGBD", "early")):
    for _crop in (False, True):
        _c = _ucn_experiment(_inp, _fus, _crop)
        PRESETS[_c.name] = (lambda i=_inp, f=_fus, cr=_crop:
                            _ucn_experiment(i, f, cr))


def get_config(name: str = "tabletop_pretrained") -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]()
