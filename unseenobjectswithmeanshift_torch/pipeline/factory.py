"""Predictor factories: preset -> runnable two-stage predictor on a device.

``build_two_stage_predictor`` ports
``unseenobjectswithmeanshift_tpu.pipeline.factory.build_two_stage_predictor``
(:20-108) for the UCN-backbone MSMFormer presets; ``build_ucn_predictor``
builds the UCN pipeline (two SEGNETs, ``pipeline/ucn.py``). Weights are random
from ``seed`` (through a ``torch.Generator``), numpy trees of the JAX package
(``variables=``, carried over by ``weights.from_jax_variables`` /
``weights.from_jax_segnet_variables``), or files (``checkpoint=``: a
reference ``.pth``, or an ``.npz`` written by ``scripts/export_release_npz.py``).

Nothing falls back: a preset of the standard-backbone family (ResNet50, Swin),
a bf16 configuration, or a pairing that the JAX package cannot build either
raises a ValueError that says why.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from ..config import Config, get_config
from ..models.meta_arch import MSMFormer
from ..models.segnet import build_segnet
from ..weights import (
    from_jax_segnet_variables, from_jax_variables, fuse_tower_state, init_random,
    load_npz_variables, load_reference_checkpoint,
)
from .two_stage import TwoStagePredictor
from .ucn import UCNPredictor

# whole-image preset -> paired crop-network preset (JAX factory.py:20-33)
CROP_PRESET_FOR = {
    "tabletop_pretrained": "crop_tabletop_pretrained",
    "tabletop_pretrained_rgb": "crop_tabletop_pretrained",
    "tabletop_pretrained_resnet50": "crop_tabletop_resnet50_rgb",
    "tabletop_swin": "tabletop_swin",
    "uoais_ucn": "crop_tabletop_pretrained",
    "uoais_resnet50": "crop_tabletop_resnet50_rgb",
    "mixture_ucn": "crop_mixture_ucn",
    "mixture_resnet50": "crop_mixture_resnet50",
    "pushing_ucn": "crop_mixture_ucn",
    "pushing_resnet50": "crop_mixture_resnet50",
}


def crop_preset_for(name: str) -> str:
    return CROP_PRESET_FOR.get(name, "crop_tabletop_pretrained")


def _configs(preset, crop_preset, default_crop, cfg, cfg_crop, no_depth: bool, bf16: bool):
    """The two configurations, with no_depth applied and checked for what
    the port serves (copies: the caller's configurations are not changed);
    raises ValueError naming the ROADMAP item that will port a refused
    preset."""
    cfg = copy.deepcopy(cfg) if cfg is not None else get_config(preset)
    cfg_crop = (copy.deepcopy(cfg_crop) if cfg_crop is not None
                else get_config(crop_preset or default_crop))
    if bf16:
        raise ValueError("bf16 is not ported: it needs bf16 variants of the kernels "
                         "(ROADMAP queue 1 item 15)")
    for c in (cfg, cfg_crop):
        if c.use_other_backbone or c.backbone.kind != "ucn":
            raise ValueError(f"preset {c.name!r} (backbone.kind {c.backbone.kind!r}) is the "
                             "standard-backbone family, not ported (ROADMAP queue 1 item 10)")
        if c.dtype != "float32":
            raise ValueError(f"preset {c.name!r}: dtype {c.dtype!r} is not ported; bf16 needs "
                             "bf16 variants of the kernels (ROADMAP queue 1 item 15)")
        if no_depth:
            c.use_depth = False
            c.backbone.input_type = "COLOR"
    if not cfg.use_depth and cfg_crop.backbone.input_type != "COLOR":
        raise ValueError(
            f"preset {cfg.name!r} reads no depth, so its crops carry none, but the crop "
            f"network {cfg_crop.name!r} takes {cfg_crop.backbone.input_type} input; the JAX "
            "package cannot build this pairing either. Pass no_depth=True or a COLOR "
            "crop preset.")
    return cfg, cfg_crop


def _weights(variables, checkpoint, convert):
    """A state_dict from a JAX tree, a reference .pth or an .npz export, or
    None for random weights."""
    if variables is not None and checkpoint is not None:
        raise ValueError("give variables or a checkpoint, not both")
    if checkpoint is not None:
        if str(checkpoint).endswith(".npz"):
            return convert(load_npz_variables(checkpoint))
        return load_reference_checkpoint(checkpoint)
    return None if variables is None else convert(variables)


def build_two_stage_predictor(preset: str = "tabletop_pretrained",
                              crop_preset: Optional[str] = None, seed: int = 0,
                              variables=None, variables_crop=None,
                              checkpoint: Optional[str] = None,
                              checkpoint_crop: Optional[str] = None,
                              no_depth: bool = False, key_stride: int = 1,
                              bf16: bool = False, device="cuda",
                              cfg: Optional[Config] = None, cfg_crop: Optional[Config] = None,
                              tile_skip: bool = False) -> TwoStagePredictor:
    """Whole-image and crop networks in eval mode on ``device``. The crop
    network follows CROP_PRESET_FOR unless crop_preset is given; cfg/cfg_crop
    override the presets (tests shrink the widths). Weights: variables /
    variables_crop (JAX trees as numpy), or checkpoint / checkpoint_crop
    (.pth or .npz; the crop network takes checkpoint when checkpoint_crop is
    None), else random from ``seed`` (the crop network from ``seed + 1``).
    no_depth: COLOR input on both networks. key_stride > 1 (opt-in, not the
    parity configuration) strides the cross-attention keys of both decoders.
    tile_skip sets ``decoder.tile_skip`` on both networks."""
    cfg, cfg_crop = _configs(preset, crop_preset, crop_preset_for(preset), cfg, cfg_crop,
                             no_depth, bf16)
    if key_stride > 1:
        if cfg.decoder.num_feature_levels != 1:
            raise ValueError(f"key_stride={key_stride} applies to the 1-level (UCN-backbone) "
                             f"decoder configs only; preset {preset!r} uses a "
                             f"{cfg.decoder.num_feature_levels}-level pyramid whose levels are "
                             "already strided")
        cfg.decoder.key_stride = key_stride
        if cfg_crop.decoder.num_feature_levels == 1:
            cfg_crop.decoder.key_stride = key_stride
    for c in (cfg, cfg_crop):
        c.decoder.tile_skip = c.decoder.tile_skip or tile_skip
    if checkpoint is not None and checkpoint_crop is None and variables_crop is None:
        checkpoint_crop = checkpoint
    models = [_build(MSMFormer, c, _weights(v, ck, from_jax_variables), seed + i, device)
              for i, (c, v, ck) in enumerate(((cfg, variables, checkpoint),
                                              (cfg_crop, variables_crop, checkpoint_crop)))]
    return TwoStagePredictor(models[0], models[1], cfg, cfg_crop)


def build_ucn_predictor(preset: str = "tabletop_pretrained",
                        crop_preset: Optional[str] = None, seed: int = 0,
                        variables=None, variables_crop=None,
                        checkpoint: Optional[str] = None,
                        checkpoint_crop: Optional[str] = None, no_depth: bool = False,
                        device="cuda", cfg: Optional[Config] = None,
                        cfg_crop: Optional[Config] = None) -> UCNPredictor:
    """Whole-image and crop SEGNETs of the UCN pipeline in eval mode on
    ``device``, with the conventions of build_two_stage_predictor (weights
    are JAX SEGNET trees or reference UCN checkpoints). The crop network
    takes crop_preset, else CROP_PRESET_FOR's pair, else the same preset (as
    the JAX package's ``cli/test_net.py --ucn`` does). With
    ``backbone.grouped_towers`` two-tower weights are fused at load time."""
    cfg, cfg_crop = _configs(preset, crop_preset, CROP_PRESET_FOR.get(preset, preset), cfg,
                             cfg_crop, no_depth, False)
    if checkpoint is not None and checkpoint_crop is None and variables_crop is None:
        checkpoint_crop = checkpoint
    nets = [_build(lambda c: build_segnet(c.backbone), c,
                   _weights(v, ck, from_jax_segnet_variables), seed + i, device)
            for i, (c, v, ck) in enumerate(((cfg, variables, checkpoint),
                                            (cfg_crop, variables_crop, checkpoint_crop)))]
    return UCNPredictor(nets[0], nets[1], cfg, cfg_crop)


def _build(make, cfg, state_dict, seed: int, device):
    with torch.device("meta"):           # no draw from the global RNG
        model = make(cfg)
    model = model.to_empty(device="cpu")
    if state_dict is None:
        init_random(model, torch.Generator().manual_seed(seed))
    else:
        grouped = any(getattr(m, "grouped", False) for m in model.modules())
        if grouped and any(".fcn_depth." in k or k.startswith("fcn_depth.") for k in state_dict):
            state_dict = fuse_tower_state(state_dict)
        model.load_state_dict(state_dict)
    return model.to(device).eval()
