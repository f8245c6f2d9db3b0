"""The port's configurations and factories against the JAX package's.

Every preset reads the same in both packages, field for field; a YAML file
with ``_base_`` loads the same; the factories refuse, with a ValueError that
names the ROADMAP item, the presets the port does not serve, and refuse the
pairings that the JAX package cannot build either (pinned here against it).
"""

import dataclasses

import jax
import pytest

from unseenobjectswithmeanshift_tpu import config as jax_config
from unseenobjectswithmeanshift_tpu.pipeline import factory as jax_factory
from unseenobjectswithmeanshift_tpu.pipeline.two_stage import (
    TwoStagePredictor as JaxTwoStagePredictor,
)
from unseenobjectswithmeanshift_torch import config
from unseenobjectswithmeanshift_torch.pipeline import factory

from torch_port_cases import _shrink, small_configs
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401


@pytest.mark.parametrize("name", sorted(jax_config.PRESETS))
def test_get_config_equals_jax(name):
    assert sorted(config.PRESETS) == sorted(jax_config.PRESETS)
    assert dataclasses.asdict(config.get_config(name)) == dataclasses.asdict(
        jax_config.get_config(name))


def test_load_config_yaml_with_base_equals_jax(tmp_path):
    base = tmp_path / "base.yaml"
    base.write_text("input: COLOR\nuse_depth: false\nbackbone:\n  input_type: COLOR\n"
                    "decoder:\n  key_stride: 2\n  dec_layers: 4\n")
    child = tmp_path / "child.yaml"
    child.write_text(f"_base_: {base}\nname: child\npixel_means_bgr: [1.0, 2.0, 3.0]\n"
                     "test:\n  max_instances: 7\nmean_shift:\n  use_pallas: true\n")
    got = config.load_config(str(child))
    assert dataclasses.asdict(got) == dataclasses.asdict(jax_config.load_config(str(child)))
    assert (got.decoder.key_stride, got.test.max_instances, got.backbone.input_type,
            got.pixel_means_bgr) == (2, 7, "COLOR", (1.0, 2.0, 3.0))
    with pytest.raises(KeyError):
        config.load_config({"decoder": {"no_such_field": 1}})


@pytest.mark.parametrize("preset,item", [("tabletop_pretrained_resnet50", "item 10"),
                                         ("tabletop_swin", "item 10"),
                                         ("uoais_resnet50", "item 10")])
def test_factory_refuses_the_standard_backbone_family(preset, item):
    """The standard-backbone presets build (tests/test_torch_r50_two_stage.py);
    what their family keeps for a later slice is refused, naming the ROADMAP
    item: here the pre-norm decoder."""
    cfg = config.get_config(preset)
    cfg.decoder.pre_norm = True
    with pytest.raises(ValueError, match=item):
        factory.build_two_stage_predictor(preset, cfg=cfg, device="cpu")


def test_factory_refuses_bf16():
    """bf16 serves every MSMFormer preset (tests/test_torch_bf16.py,
    tests/test_torch_r50_two_stage.py); what bf16 is still refused: what the
    standard-backbone family keeps for later (ROADMAP queue 1 item 10, here
    the decoder without attention masks) and a compute dtype the JAX package
    does not have."""
    cfg = config.get_config("tabletop_pretrained_resnet50")
    cfg.decoder.disable_attention_mask = True
    with pytest.raises(ValueError, match="item 10"):
        factory.build_two_stage_predictor("tabletop_pretrained_resnet50", bf16=True, cfg=cfg,
                                          device="cpu")
    cfg = config.get_config()
    cfg.dtype = "float16"
    with pytest.raises(ValueError, match="dtype must be one of"):
        factory.build_ucn_predictor(cfg=cfg, bf16=True, device="cpu")


@pytest.mark.parametrize("preset,error", [
    ("tabletop_pretrained_rgb", AttributeError),   # COLOR stage 1, RGBD crop network
    ("ucn_rgbd_cat", ValueError),                 # 128-d embedding, conv_dim 64
])
def test_factory_refuses_what_the_jax_package_cannot_build(preset, error):
    """The JAX package fails on these pairings (its factory's predictor and
    init, here at the small widths); the port refuses them with a ValueError
    that says why, and builds them with no_depth=True, as the JAX package
    does."""
    jc, jcc = (_shrink(jax_config.get_config(n))
               for n in (preset, jax_factory.crop_preset_for(preset)))
    with pytest.raises(error):
        JaxTwoStagePredictor(jc, jcc).init(jax.random.PRNGKey(0), (32, 32), crop_size=32)
    with pytest.raises(ValueError, match="JAX package cannot build"):
        factory.build_two_stage_predictor(preset, device="cpu")
    _, _, pc, pcc = small_configs()
    for c in (pc, pcc):
        c.backbone.input_type, c.use_depth = "COLOR", False
    pred = factory.build_two_stage_predictor(preset, cfg=pc, cfg_crop=pcc, no_depth=True,
                                             device="cpu")
    assert pred.model.pretrained_backbone.input_type == "COLOR"


def test_key_stride_and_crop_presets_follow_jax():
    assert factory.CROP_PRESET_FOR == jax_factory.CROP_PRESET_FOR
    for name in config.PRESETS:
        assert factory.crop_preset_for(name) == jax_factory.crop_preset_for(name)
    _, _, pc, pcc = small_configs()
    pred = factory.build_two_stage_predictor(cfg=pc, cfg_crop=pcc, key_stride=3, device="cpu")
    assert pred.model.sem_seg_head.predictor.key_stride == 3
    assert pred.model_crop.sem_seg_head.predictor.key_stride == 3
    assert pc.decoder.key_stride == 1                 # the caller's config is not changed
    with pytest.raises(ValueError, match="1-level"):
        multi = config.get_config()
        multi.decoder.num_feature_levels = 3
        factory.build_two_stage_predictor(cfg=multi, key_stride=2, device="cpu")
