"""The port's decoder and meta-architecture against the JAX package on the CPU.

The port's decoder always takes the fused structure (input_proj and
level_embed folded into the cross-attention's k/v projections, the mask from
me . mf); on the CPU the JAX decoder takes its unfused path, which has the
same math. Weights are random with the mask head's last layer scaled by 30,
so attention masks are decisive and a 1e-7 difference cannot flip them.
"""

import numpy as np
import jax.numpy as jnp
import torch

from unseenobjectswithmeanshift_tpu.models.decoder import MeanShiftDecoder as JaxDecoder
from unseenobjectswithmeanshift_tpu.models.meta_arch import MSMFormer as JaxMSMFormer
from unseenobjectswithmeanshift_tpu.utils.checkpoint import convert_msmformer_checkpoint
from unseenobjectswithmeanshift_torch.models.decoder import MeanShiftDecoder
from unseenobjectswithmeanshift_torch.models.meta_arch import MSMFormer
from unseenobjectswithmeanshift_torch.weights import from_jax_variables, init_random

from torch_port_cases import E, FF, L, MD, NH, Q, jax_msmformer_variables, rgbd, small_configs
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401

# fp32 on both sides, summed in different orders (JAX at HIGHEST precision):
# differences are ~1e-6 and reach ~1e-5 after 3 layers of kappa = 30 softmax
# and LayerNorm. Logits and mask embeds are O(1) (mask embeds O(30) after the
# scaling, hence the relative term).
ATOL, RTOL = 1e-4, 1e-5


def assert_close(got, want, name):
    """ATOL/RTOL, with the absolute part scaled to the tensor's magnitude for
    the mask logits: each is a 48-term sum whose terms reach |me . mf| ~ 1e2,
    so its rounding error follows the terms, not the (possibly small) sum."""
    want = np.asarray(want)
    atol = ATOL * max(1.0, float(np.abs(want).max()) / 10) if name == "pred_masks" else ATOL
    np.testing.assert_allclose(got, want, atol=atol, rtol=RTOL, err_msg=name)


def _decisive(model):
    with torch.no_grad():
        lin = model.mask_embed.layers[2]
        lin.weight *= 30.0
        lin.bias *= 30.0
    return model


def test_decoder_matches_jax_decoder(rng):
    IC, h, w = 64, 16, 16
    dec = _decisive(init_random(
        MeanShiftDecoder(hidden_dim=E, num_queries=Q, nheads=NH, dim_feedforward=FF,
                         dec_layers=L, mask_dim=MD, in_channels=IC),
        torch.Generator().manual_seed(1))).eval()
    x = rng.randn(1, h, w, IC).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    mf = rng.randn(1, h, w, MD).astype(np.float32)
    with torch.no_grad():
        got = dec(torch.from_numpy(x), torch.from_numpy(mf), materialize_masks=True)

    sd = {f"sem_seg_head.predictor.{k}": v.numpy() for k, v in dec.state_dict().items()}
    params = convert_msmformer_checkpoint(sd)["params"]["predictor"]
    jdec = JaxDecoder(hidden_dim=E, num_queries=Q, nheads=NH, dim_feedforward=FF,
                      dec_layers=L, mask_dim=MD, in_channels=IC)
    want = jdec.apply({"params": params}, [jnp.asarray(x)], jnp.asarray(mf))

    for key in ("pred_logits", "mask_embed", "pred_masks"):
        assert_close(got[key].numpy(), want[key], key)
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == L
    for g, wnt in zip(got["aux_outputs"], want["aux_outputs"]):
        np.testing.assert_allclose(g["pred_logits"].numpy(), np.asarray(wnt["pred_logits"]),
                                   atol=ATOL, rtol=RTOL)


def test_msmformer_matches_jax(rng):
    jc, _, pc, _ = small_configs()
    variables = jax_msmformer_variables(jc, seed=2)
    me2 = variables["params"]["predictor"]["mask_embed"]["layers_2"]
    me2["kernel"] = me2["kernel"] * 30.0
    me2["bias"] = me2["bias"] * 30.0
    img, xyz = rgbd(rng)
    want = JaxMSMFormer(jc).apply(variables, jnp.asarray(img), jnp.asarray(xyz))

    model = MSMFormer(pc).eval()
    model.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(xyz), light=False)
        light = model(torch.from_numpy(img), torch.from_numpy(xyz), light=True)
    for key in ("pred_logits", "mask_embed", "pred_masks"):
        assert_close(got[key].numpy(), want[key], key)
    # the light path returns the mask features instead of the masks
    masks = torch.einsum("bqc,bhwc->bqhw", light["mask_embed"], light["mask_features"])
    np.testing.assert_allclose(masks.numpy(), got["pred_masks"].numpy(), atol=1e-4)
