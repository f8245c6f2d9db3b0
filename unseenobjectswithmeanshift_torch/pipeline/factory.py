"""Predictor factories: preset -> runnable two-stage predictor on a device.

``build_two_stage_predictor`` ports
``unseenobjectswithmeanshift_tpu.pipeline.factory.build_two_stage_predictor``
for the UCN-backbone MSMFormer presets; ``build_ucn_predictor`` builds the UCN
pipeline (two SEGNETs, ``pipeline/ucn.py``). Weights are random from ``seed``
(through a ``torch.Generator``), or numpy trees of the JAX package carried
over by ``weights.from_jax_variables`` / ``weights.from_jax_segnet_variables``.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch

from ..config import get_config
from ..models.meta_arch import MSMFormer
from ..models.segnet import SEGNET
from ..weights import from_jax_segnet_variables, from_jax_variables, init_random
from .two_stage import TwoStagePredictor
from .ucn import UCNPredictor

CROP_PRESET_FOR = {"tabletop_pretrained": "crop_tabletop_pretrained"}


def build_two_stage_predictor(preset: str = "tabletop_pretrained",
                              crop_preset: Optional[str] = None, seed: int = 0,
                              variables=None, variables_crop=None,
                              device="cuda", cfg=None, cfg_crop=None,
                              tile_skip: bool = False) -> TwoStagePredictor:
    """Whole-image and crop networks in eval mode on ``device``. cfg/cfg_crop
    override the presets (tests shrink the widths). variables/variables_crop:
    JAX variable trees as numpy; without them the weights are random from
    ``seed`` (the crop network from ``seed + 1``). tile_skip sets
    ``decoder.tile_skip`` on both networks."""
    cfg = cfg or get_config(preset)
    cfg_crop = cfg_crop or get_config(crop_preset or CROP_PRESET_FOR.get(preset, preset))
    if tile_skip:
        cfg, cfg_crop = (replace(c, decoder=replace(c.decoder, tile_skip=True))
                         for c in (cfg, cfg_crop))
    models = [_build(MSMFormer, c, v, from_jax_variables, seed + i, device)
              for i, (c, v) in enumerate(((cfg, variables), (cfg_crop, variables_crop)))]
    return TwoStagePredictor(models[0], models[1], cfg, cfg_crop)


def build_ucn_predictor(preset: str = "tabletop_pretrained",
                        crop_preset: Optional[str] = None, seed: int = 0,
                        variables=None, variables_crop=None, device="cuda",
                        cfg=None, cfg_crop=None) -> UCNPredictor:
    """Whole-image and crop SEGNETs of the UCN pipeline in eval mode on
    ``device``, with the same conventions as build_two_stage_predictor:
    variables/variables_crop are JAX SEGNET trees as numpy, else the weights
    are random from ``seed`` (the crop network from ``seed + 1``)."""
    cfg = cfg or get_config(preset)
    cfg_crop = cfg_crop or get_config(crop_preset or CROP_PRESET_FOR.get(preset, preset))
    nets = [_build(lambda c: SEGNET(c.backbone.num_units), c, v, from_jax_segnet_variables,
                   seed + i, device)
            for i, (c, v) in enumerate(((cfg, variables), (cfg_crop, variables_crop)))]
    return UCNPredictor(nets[0], nets[1], cfg, cfg_crop)


def _build(make, cfg, variables, convert, seed: int, device):
    with torch.device("meta"):           # no draw from the global RNG
        model = make(cfg)
    model = model.to_empty(device="cpu")
    if variables is None:
        init_random(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(convert(variables))
    return model.to(device).eval()
