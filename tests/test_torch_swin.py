"""The port's Swin-T backbone against the JAX package on the CPU.

Swin-T at full depth on a 224 x 224 image, where every stage is a whole
number of 7 x 7 windows (56, 28, 14, 7), so the reference's per-block
padding (the port's) and the JAX package's per-stage padding coincide.
Weights are drawn by the port and carried to JAX by the JAX package's
``convert_swin_checkpoint``, with two settings of the JAX package's put on
the port's side, as ROADMAP.md section 3 lists them under "JAX-side
defects": LayerNorm eps 1e-6 (flax's default; the port follows the
reference's 1e-5) and the order of the 2x2 neighbours in patch merging (the
converter copies the reference's merge weights straight, but the JAX
PatchMerging concatenates quarters 1 and 2 swapped, so the test permutes
them). ``from_jax_variables`` is checked to invert that conversion.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from unseenobjectswithmeanshift_tpu.models.swin import SwinTransformer as JaxSwin
from unseenobjectswithmeanshift_tpu.utils.checkpoint import convert_swin_checkpoint
from unseenobjectswithmeanshift_torch.models.swin import SwinTransformer
from unseenobjectswithmeanshift_torch.weights import (
    _merge_perm, _swin_backbone, init_random,
)
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401

JAX_LN_EPS = 1e-6


def _jax_params(model):
    sd = {f"backbone.{k}": v.detach().numpy() for k, v in model.state_dict().items()}
    params = convert_swin_checkpoint(sd)["params"]
    for name, p in params.items():
        if name.startswith("merge"):
            perm = _merge_perm(p["norm"]["scale"].shape[0])
            p["norm"] = {k: v[perm] for k, v in p["norm"].items()}
            p["reduction"]["kernel"] = p["reduction"]["kernel"][perm]
    return params


def test_swin_matches_jax(rng):
    m = init_random(SwinTransformer(), torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        for sub in m.modules():
            if isinstance(sub, torch.nn.LayerNorm):
                sub.eps = JAX_LN_EPS
                sub.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
    x = rng.randn(1, 224, 224, 3).astype(np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    params = _jax_params(m)
    want = jax.jit(JaxSwin().apply)({"params": params}, jnp.asarray(x))
    for i, (k, c) in enumerate(zip(("res2", "res3", "res4", "res5"), (96, 192, 384, 768))):
        assert got[k].shape == (1, c, 56 >> i, 56 >> i)
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(), np.asarray(want[k]),
                                   atol=2e-4, rtol=1e-4, err_msg=k)

    # the port's converter takes the JAX tree back to the same weights
    sd = {}
    _swin_backbone(params, sd)
    for k, v in m.state_dict().items():
        np.testing.assert_array_equal(sd[f"backbone.{k}"].numpy(), v.numpy(), err_msg=k)


def test_swin_pads_windows_inside_each_block(rng):
    """At a size that is not a whole number of windows (64 x 96: stage 1 is
    16 x 24, stage 4 is 2 x 3) the outputs keep their sizes and are finite
    (a narrow Swin: the padding does not depend on the width)."""
    m = init_random(SwinTransformer(embed_dim=24, num_heads=(1, 2, 3, 6)),
                    torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        out = m(torch.from_numpy(rng.randn(1, 3, 64, 96).astype(np.float32)))
    assert [tuple(out[f"res{i + 2}"].shape[-2:]) for i in range(4)] == [
        (16, 24), (8, 12), (4, 6), (2, 3)]
    assert all(torch.isfinite(v).all() for v in out.values())
