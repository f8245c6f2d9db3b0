"""The standard-backbone two-stage slice against the JAX package, the
factory's standard-backbone presets, and reference-checkpoint loading.

The two-stage test runs ``tabletop_pretrained_resnet50`` with
``crop_tabletop_resnet50_rgb`` at small widths (torch_port_cases: hidden 96,
4 heads, 16 queries, 3 decoder layers, 5 instances, 32 px crops; the full
ResNet50 and a 2-layer MSDeformAttn encoder at conv_dim 64) on a 64 x 96
image. The weights are the port's random ones (``build_two_stage_predictor``
with a seed) made decisive as chip_smoke.decisive_predictor makes them: the
mask head x30 and the class kernel zeroed. They are carried to JAX by the
JAX package's ``convert_r50_msmformer_checkpoint``, with the JAX package's
GroupNorm eps and level-embedding order (tests/test_torch_r50.py says why).
Stage-1 and refined labels must be equal.
"""

import copy
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from unseenobjectswithmeanshift_tpu.config import get_config as jax_get_config
from unseenobjectswithmeanshift_tpu.pipeline.factory import (
    CROP_PRESET_FOR as JAX_CROP_PRESET_FOR,
)
from unseenobjectswithmeanshift_tpu.pipeline.two_stage import TwoStagePredictor
from unseenobjectswithmeanshift_tpu.utils.checkpoint import convert_r50_msmformer_checkpoint
from unseenobjectswithmeanshift_torch.config import get_config
from unseenobjectswithmeanshift_torch.models.meta_arch import StandardMaskFormer
from unseenobjectswithmeanshift_torch.pipeline import factory
from unseenobjectswithmeanshift_torch.weights import (
    from_jax_variables, init_random, load_reference_checkpoint,
)

from torch_port_cases import _shrink
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401

ENC_LAYERS = 2
HW = (64, 96)


def _small(get, name):
    cfg = _shrink(get(name))
    cfg.pixel_decoder.transformer_enc_layers = ENC_LAYERS
    return cfg


def _decisive(pred):
    with torch.no_grad():
        for model in (pred.model, pred.model_crop):
            head = model.sem_seg_head.predictor
            head.mask_embed.layers[2].weight *= 30.0
            head.mask_embed.layers[2].bias *= 30.0
            head.class_embed.weight.zero_()
            for m in model.modules():
                if isinstance(m, torch.nn.GroupNorm):
                    m.eps = 1e-6                   # the JAX package's GroupNorm eps
    return pred


def _to_jax(model):
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    v = convert_r50_msmformer_checkpoint(sd)
    pdv = v["params"]["pixel_decoder"]
    pdv["level_embed"] = pdv["level_embed"][::-1]   # the JAX package's order
    return jax.tree.map(jnp.asarray, v)


@pytest.fixture(scope="module")
def slice_run():
    name = "tabletop_pretrained_resnet50"
    crop = factory.crop_preset_for(name)
    pc, pcc = _small(get_config, name), _small(get_config, crop)
    pred = _decisive(factory.build_two_stage_predictor(name, cfg=pc, cfg_crop=pcc, seed=3,
                                                       device="cpu"))
    rng = np.random.RandomState(0)
    img = (rng.rand(1, *HW, 3) * 255).astype(np.float32)
    s1 = pred.stage1(torch.from_numpy(img))
    refined = pred.refine(s1)
    jc, jcc = _small(jax_get_config, name), _small(jax_get_config, crop)
    forward = jax.jit(functools.partial(TwoStagePredictor(jc, jcc)._forward, osd=False,
                                        refine=True))
    jl, jr = forward(_to_jax(pred.model), _to_jax(pred.model_crop), jnp.asarray(img), None)
    return pred, s1, refined, np.asarray(jl), np.asarray(jr)


def test_r50_two_stage_labels_equal_jax(slice_run):
    pred, s1, refined, jl, jr = slice_run
    assert isinstance(pred.model, StandardMaskFormer)
    assert pred.cfg_crop.name == "crop_tabletop_resnet50_rgb"
    # the comparison must exercise real instances and a real stage 2
    assert len(np.unique(jl)) >= 3, "stage 1 produced fewer than two instances"
    assert int(s1.crops[0].present.sum()) >= 2
    np.testing.assert_array_equal(s1.labels.numpy(), jl)
    np.testing.assert_array_equal(refined.numpy(), jr)


def test_r50_light_outputs_are_stride_4(slice_run):
    """The light path returns stride-4 mask features, and the materialized
    masks are their product with the mask embeds upsampled to the input."""
    pred = slice_run[0]
    img = torch.rand(1, *HW, 3, generator=torch.Generator().manual_seed(1)) * 255
    with torch.no_grad():
        light = pred.model(img, light=True)
        full = pred.model(img, light=False)
    assert light["mask_features"].shape == (1, HW[0] // 4, HW[1] // 4, 48)
    masks = torch.einsum("bqc,bhwc->bqhw", light["mask_embed"], light["mask_features"])
    up = torch.nn.functional.interpolate(masks, size=HW, mode="bilinear", align_corners=False)
    assert full["pred_masks"].shape == (1, 16, *HW)
    np.testing.assert_allclose(full["pred_masks"].numpy(), up.numpy(), atol=1e-3, rtol=1e-5)


def test_from_jax_variables_inverts_the_r50_converter(slice_run):
    model = slice_run[0].model
    back = from_jax_variables(jax.tree.map(np.asarray, _to_jax(model)))
    sd = model.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


@pytest.mark.parametrize("preset", ["tabletop_pretrained_resnet50", "uoais_resnet50",
                                    "mixture_resnet50", "pushing_resnet50", "tabletop_swin"])
def test_factory_builds_the_standard_backbone_presets(preset):
    """Every standard-backbone whole-image preset of the JAX package's
    CROP_PRESET_FOR builds with its crop preset, in fp32 and (but Swin, whose
    full-width random init is the slowest on the CPU; bf16 is a dtype field,
    the same for every preset) in bf16 with no_depth; pushing_resnet50 reads
    depth (for the depth filter and the crops) unless no_depth. (Swin in bf16
    is chip_smoke.py's to build on the card.)"""
    assert preset in JAX_CROP_PRESET_FOR
    for bf16, no_depth in ((False, False),) if preset == "tabletop_swin" else (
            (False, False), (True, True)):
        pred = factory.build_two_stage_predictor(preset, bf16=bf16, no_depth=no_depth,
                                                 device="meta")
        assert pred.cfg_crop.name == JAX_CROP_PRESET_FOR[preset]
        assert isinstance(pred.model, StandardMaskFormer)
        assert isinstance(pred.model_crop, StandardMaskFormer)
        assert pred.cfg.dtype == pred.cfg_crop.dtype == ("bfloat16" if bf16 else "float32")
        assert pred.cfg.use_depth == (preset == "pushing_resnet50" and not no_depth)
    with pytest.raises(ValueError, match="1-level"):
        factory.build_two_stage_predictor(preset, key_stride=2, device="meta")


@pytest.mark.parametrize("field,value", [("pre_norm", True), ("disable_attention_mask", True),
                                         ("use_meanshift_cross_attention", False),
                                         ("use_meanshift_self_attention", False),
                                         ("hidden_dim", 64)])
def test_factory_refuses_what_stays_for_later(field, value):
    """What ROADMAP queue 1 item 10 keeps for a later slice raises a
    ValueError naming it (hidden_dim 64 = conv_dim: the decoder without an
    input projection)."""
    cfg = get_config("tabletop_pretrained_resnet50")
    setattr(cfg.decoder, field, value)
    with pytest.raises(ValueError, match="item 10"):
        factory.build_two_stage_predictor("tabletop_pretrained_resnet50", cfg=cfg,
                                          device="meta")


def test_ucn_factory_refuses_a_standard_backbone_preset():
    with pytest.raises(ValueError, match="build_two_stage_predictor"):
        factory.build_ucn_predictor("tabletop_pretrained_resnet50", device="meta")


@pytest.mark.parametrize("kind", ["resnet50", "swin"])
def test_reference_checkpoint_loads_as_it_is(tmp_path, kind):
    """A reference .pth under the reference's key names (``model.`` prefix,
    detectron2's wrapper, buffers the port does not keep) loads strictly into
    the port's StandardMaskFormer with the same values."""
    cfg = _small(get_config, "tabletop_pretrained_resnet50" if kind == "resnet50"
                 else "tabletop_swin")
    model = init_random(StandardMaskFormer(cfg), torch.Generator().manual_seed(4))
    ckpt = {f"model.{k}": v.clone() for k, v in model.state_dict().items()}
    ckpt.update({"model.pixel_mean": torch.zeros(3), "model.pixel_std": torch.ones(3),
                 "model.criterion.empty_weight": torch.ones(3)})
    if kind == "swin":
        ckpt["model.backbone.layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(
            49, 49, dtype=torch.long)
    path = tmp_path / "model.pth"
    torch.save({"model": ckpt, "iteration": 7}, path)
    sd = load_reference_checkpoint(path)
    fresh = StandardMaskFormer(copy.deepcopy(cfg))
    fresh.load_state_dict(sd)                       # strict
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    if kind == "resnet50":                          # the factory's checkpoint= path
        pred = factory.build_two_stage_predictor(cfg.name, cfg=cfg, cfg_crop=copy.deepcopy(cfg),
                                                 checkpoint=str(path), device="cpu")
        assert torch.equal(pred.model_crop.sem_seg_head.predictor.level_embed.weight,
                           model.sem_seg_head.predictor.level_embed.weight)


@pytest.mark.parametrize("no_depth", [False, True])
def test_no_depth_pairing(no_depth):
    """tabletop_pretrained_resnet50 reads no depth; its crop network's
    backbone.input_type ("RGBD", the UCN SEGNET's field) means nothing for a
    ResNet50, so the pairing builds, as the JAX package builds it."""
    name = "tabletop_pretrained_resnet50"
    pc, pcc = _small(get_config, name), _small(get_config, factory.crop_preset_for(name))
    assert not pc.use_depth and pcc.backbone.input_type == "RGBD"
    pred = factory.build_two_stage_predictor(name, cfg=pc, cfg_crop=pcc, no_depth=no_depth,
                                             device="cpu")
    labels, refined = pred(torch.rand(1, *HW, 3) * 255)
    assert labels.shape == refined.shape == (1, *HW)


def test_demo_serves_a_standard_backbone_preset(tmp_path, capsys):
    """``--preset`` (the same as ``--config``) selects the ResNet50 preset;
    stage 1 only (``--no-refine``) keeps the CPU run small."""
    import cv2
    from unseenobjectswithmeanshift_torch.cli import demo

    rng = np.random.RandomState(5)
    cv2.imwrite(str(tmp_path / "000000-color.png"),
                rng.randint(0, 256, size=(32, 32, 3)).astype(np.uint8))
    demo.main(["--imgdir", str(tmp_path), "--preset", "tabletop_pretrained_resnet50",
               "--device", "cpu", "--no-refine"])
    assert "done" in capsys.readouterr().out
    label = cv2.imread(str(tmp_path / "000000-color-label.png"), cv2.IMREAD_UNCHANGED)
    assert label.shape == (32, 32) and label.dtype == np.uint8
