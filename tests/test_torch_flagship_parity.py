"""Flagship-shape parity of the port: the whole-image network at 480x640 and
the crop network at 224x224, with the flagship widths (tabletop_pretrained /
crop_tabletop_pretrained: hidden 256, 8 heads, 100 queries, 6 layers, mask_dim
256, FFN 2048), against the JAX package on the same decisive random weights,
on pred_logits and pred_masks (the tolerances of test_torch_decoder.py).

The small-width tests (test_torch_decoder.py, test_torch_input_variants.py)
catch composition faults, not faults that depend on the resolution or the
widths. This one costs minutes of CPU time and several GB, so it is gated
behind UOMS_FLAGSHIP_PARITY=1, as tests/test_flagship_parity.py is:

    UOMS_FLAGSHIP_PARITY=1 python -m pytest -q tests/test_torch_flagship_parity.py
"""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(
    os.environ.get("UOMS_FLAGSHIP_PARITY") != "1",
    reason="flagship-shape parity is heavy; set UOMS_FLAGSHIP_PARITY=1")


@pytest.mark.parametrize("preset,hw", [("tabletop_pretrained", (480, 640)),
                                       ("crop_tabletop_pretrained", (224, 224))])
def test_flagship_shape_networks_match_jax(rng, preset, hw):
    import jax
    import jax.numpy as jnp
    import torch

    from unseenobjectswithmeanshift_tpu.config import get_config as jax_get_config
    from unseenobjectswithmeanshift_tpu.models.meta_arch import MSMFormer as JaxMSMFormer
    from unseenobjectswithmeanshift_torch.config import get_config
    from unseenobjectswithmeanshift_torch.models.meta_arch import MSMFormer
    from unseenobjectswithmeanshift_torch.weights import from_jax_variables

    from test_torch_decoder import assert_close
    from torch_port_cases import rgbd

    jc = jax_get_config(preset)
    img, xyz = rgbd(rng, hw)
    variables = jax.tree.map(np.asarray, JaxMSMFormer(jc).init(
        jax.random.PRNGKey(0), img[:, :64, :64], xyz[:, :64, :64]))
    me2 = variables["params"]["predictor"]["mask_embed"]["layers_2"]
    me2["kernel"] = me2["kernel"] * 30.0          # decisive masks
    me2["bias"] = me2["bias"] * 30.0
    want = JaxMSMFormer(jc).apply(variables, jnp.asarray(img), jnp.asarray(xyz))
    model = MSMFormer(get_config(preset)).eval()
    model.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(xyz), light=False)
    for key in ("pred_logits", "pred_masks"):
        assert got[key].shape == tuple(want[key].shape)
        assert_close(got[key].numpy(), want[key], key)
