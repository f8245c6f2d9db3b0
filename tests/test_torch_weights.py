"""Weight round-trips between the JAX package's variable trees and the port's
state_dict, in both directions, through the port's ``from_jax_variables`` and
the JAX package's ``convert_msmformer_checkpoint``."""

import jax
import numpy as np
import torch

from unseenobjectswithmeanshift_tpu.utils.checkpoint import convert_msmformer_checkpoint
from unseenobjectswithmeanshift_torch.models.meta_arch import MSMFormer
from unseenobjectswithmeanshift_torch.weights import from_jax_variables, init_random

from torch_port_cases import jax_msmformer_variables, small_configs
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_jax_variables_to_port_and_back_are_identical():
    jc, _, pc, _ = small_configs()
    variables = jax_msmformer_variables(jc)
    model = MSMFormer(pc)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    back = convert_msmformer_checkpoint(
        {k: v.numpy() for k, v in model.state_dict().items()})
    want, got = _leaves(variables), _leaves(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_state_dict_to_jax_and_back_is_identical():
    _, _, pc, _ = small_configs()
    model = init_random(MSMFormer(pc), torch.Generator().manual_seed(3))
    sd = model.state_dict()
    back = from_jax_variables(convert_msmformer_checkpoint(
        {k: v.numpy() for k, v in sd.items()}))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_random_init_is_seeded():
    _, _, pc, _ = small_configs()
    a = init_random(MSMFormer(pc), torch.Generator().manual_seed(5)).state_dict()
    b = init_random(MSMFormer(pc), torch.Generator().manual_seed(5)).state_dict()
    c = init_random(MSMFormer(pc), torch.Generator().manual_seed(6)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["sem_seg_head.predictor.query_feat.weight"],
                           c["sem_seg_head.predictor.query_feat.weight"])
