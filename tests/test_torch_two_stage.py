"""The port's two-stage predictor against the JAX ``TwoStagePredictor`` at
small width on shared weights.

The weights are those of tests/test_e2e_parity.py: a torch oracle of the
reference architecture with the mask head scaled by 30 (decisive masks),
seed 10 (several instances of varied size), converted to JAX variables by the
JAX package's converter and carried into the port by
``weights.from_jax_variables``. Stage-1 and refined labels must be equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from unseenobjectswithmeanshift_tpu.pipeline.two_stage import TwoStagePredictor
from unseenobjectswithmeanshift_tpu.utils.checkpoint import convert_msmformer_checkpoint
from unseenobjectswithmeanshift_torch.ops.fused_cross_attention import fused_uoms_cross_attention
from unseenobjectswithmeanshift_torch.pipeline.factory import build_two_stage_predictor

from test_e2e_parity import TorchMetaArch
from torch_port_cases import E, FF, L, MD, NH, Q, rgbd, small_configs
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401


def _shared_variables():
    torch.manual_seed(10)
    with torch.no_grad():
        nets = [TorchMetaArch(E, NH, Q, L, MD, FF, 2).eval() for _ in range(2)]
        for m in nets:
            lin = m.sem_seg_head.predictor.mask_embed.layers[2]
            lin.weight *= 30.0
            lin.bias *= 30.0
    return [convert_msmformer_checkpoint(m.state_dict()) for m in nets]


def test_two_stage_labels_equal_jax(rng):
    jc, jcc, pc, pcc = small_configs()
    v1, v2 = _shared_variables()
    img, xyz = rgbd(rng)

    jl, jr = TwoStagePredictor(jc, jcc)._forward(
        jax.tree.map(jnp.asarray, v1), jax.tree.map(jnp.asarray, v2),
        jnp.asarray(img), jnp.asarray(xyz), osd=False, refine=True)
    jl, jr = np.asarray(jl), np.asarray(jr)

    pred = build_two_stage_predictor(variables=v1, variables_crop=v2, device="cpu",
                                     cfg=pc, cfg_crop=pcc)
    before = fused_uoms_cross_attention.launches
    s1 = pred.stage1(torch.from_numpy(img), torch.from_numpy(xyz))
    refined = pred.refine(s1)
    assert fused_uoms_cross_attention.launches == before   # CPU: plain version only

    # the comparison must exercise real instances and a real stage 2
    assert len(np.unique(jl)) >= 3, "stage 1 produced fewer than two instances"
    assert int(s1.crops[0].present.sum()) >= 2
    assert s1.labels.dtype == refined.dtype == torch.int32
    np.testing.assert_array_equal(s1.labels.numpy(), jl)
    np.testing.assert_array_equal(refined.numpy(), jr)

    labels, refined2 = pred(torch.from_numpy(img), torch.from_numpy(xyz))
    np.testing.assert_array_equal(refined2.numpy(), jr)
    _, unrefined = pred(torch.from_numpy(img), torch.from_numpy(xyz), refine=False)
    np.testing.assert_array_equal(unrefined.numpy(), jl)
