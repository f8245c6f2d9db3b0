"""SEGNET and MSMFormer of every input type and fusion against the JAX package.

SEGNET in COLOR, DEPTH, RGBD 'early', 'add' and 'cat', each with and without
``grouped_towers`` (the JAX package ignores it where there are not two
towers; with two it runs them as one grouped stack, whose weights are the
two-tower trees fused at load time). Then the MSMFormer of the input types
no shipped flagship preset uses, COLOR (no xyz), DEPTH and 'early', at the
small widths of ``torch_port_cases.py``, on pred_logits and pred_masks; and
key_stride 2 and 3 through the meta-architecture.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unseenobjectswithmeanshift_tpu.models.meta_arch import MSMFormer as JaxMSMFormer
from unseenobjectswithmeanshift_tpu.models.segnet import SEGNET as JaxSEGNET
from unseenobjectswithmeanshift_tpu.utils.checkpoint import fuse_grouped_towers
from unseenobjectswithmeanshift_torch.models.meta_arch import MSMFormer
from unseenobjectswithmeanshift_torch.models.segnet import SEGNET
from unseenobjectswithmeanshift_torch.weights import (
    from_jax_segnet_variables, from_jax_variables, fuse_tower_state,
)

from test_torch_backbone import _perturb_bn
from test_torch_decoder import assert_close
from torch_port_cases import rgbd, small_configs

VARIANTS = [("COLOR", "add"), ("DEPTH", "add"), ("RGBD", "early"), ("RGBD", "add"),
            ("RGBD", "cat")]


@pytest.mark.parametrize("input_type,fusion", VARIANTS)
def test_segnet_variant_matches_jax(rng, input_type, fusion):
    """Without and with grouped_towers: where there is one tower the JAX
    package builds the same network either way, and so does the port."""
    img, xyz = rgbd(rng, (32, 32))
    jnet = JaxSEGNET(input_type=input_type, fusion_type=fusion)
    v = jax.tree.map(np.array, jnet.init(jax.random.PRNGKey(3), img, xyz))
    _perturb_bn(v["params"], rng)
    _perturb_bn(v["batch_stats"], rng)
    two_tower = input_type == "RGBD" and fusion != "early"
    sd = from_jax_segnet_variables(v)
    assert any(k.startswith("fcn_depth.") for k in sd) == two_tower
    want = np.asarray(jnet.apply(v, img, xyz))
    for grouped in (False, True):
        if grouped and two_tower:
            want = np.asarray(JaxSEGNET(input_type=input_type, fusion_type=fusion,
                                        grouped_towers=True).apply(fuse_grouped_towers(v),
                                                                   img, xyz))
        net = SEGNET(64, input_type, fusion, grouped_towers=grouped).eval()
        assert net.grouped == (grouped and two_tower)
        net.load_state_dict(fuse_tower_state(sd) if net.grouped else sd)
        with torch.no_grad():
            got = net(torch.from_numpy(img),
                      None if input_type == "COLOR" else torch.from_numpy(xyz))
        assert got.shape == (1, 32, 32, 128 if fusion == "cat" and two_tower else 64)
        # as tests/test_torch_backbone.py: ~1e-6 after 37 fp32 convs a tower, held at 2e-5
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, err_msg=f"grouped={grouped}")


def _msmformer_case(rng, input_type, fusion, key_stride=1):
    jc, _, pc, _ = small_configs()
    for c in (jc, pc):
        c.backbone.input_type, c.backbone.fusion_type = input_type, fusion
        c.use_depth = input_type != "COLOR"
        c.decoder.key_stride = key_stride
    img, xyz = rgbd(rng, (32, 32))
    xyz = None if input_type == "COLOR" else xyz
    init_cfg = copy.deepcopy(jc)
    init_cfg.decoder.key_stride = 1
    variables = jax.tree.map(np.asarray, JaxMSMFormer(init_cfg).init(
        jax.random.PRNGKey(4), img, xyz))
    me2 = variables["params"]["predictor"]["mask_embed"]["layers_2"]
    me2["kernel"] = me2["kernel"] * 30.0           # decisive masks (test_torch_decoder.py)
    me2["bias"] = me2["bias"] * 30.0
    want = JaxMSMFormer(jc).apply(variables, jnp.asarray(img),
                                  None if xyz is None else jnp.asarray(xyz))
    model = MSMFormer(pc).eval()
    model.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        got = model(torch.from_numpy(img), None if xyz is None else torch.from_numpy(xyz),
                    light=False)
    return got, want


@pytest.mark.parametrize("input_type,fusion", [("COLOR", "add"), ("DEPTH", "add"),
                                               ("RGBD", "early")])
def test_msmformer_input_variant_matches_jax(rng, input_type, fusion):
    got, want = _msmformer_case(rng, input_type, fusion)
    for key in ("pred_logits", "pred_masks"):
        assert_close(got[key].numpy(), want[key], key)


@pytest.mark.parametrize("key_stride", [2, 3])
def test_msmformer_key_stride_matches_jax(rng, key_stride):
    """key_stride 2 and 3 at 32x32 (keys 16 x 16, and 11 x 11 = 121 = 64 +
    57: a ragged last tile); the masks stay full resolution."""
    got, want = _msmformer_case(rng, "RGBD", "add", key_stride)
    assert got["pred_masks"].shape[-2:] == (32, 32)
    for key in ("pred_logits", "pred_masks"):
        assert_close(got[key].numpy(), want[key], key)
