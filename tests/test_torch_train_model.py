"""The port's train forward against the JAX package's, piece by piece, on the CPU.

- The decoder's unfused path (the one both packages train), run under
  ``torch.utils.checkpoint`` as in training: every layer's class logits and
  mask embed, and the gradient of every decoder parameter, against the JAX
  ``MeanShiftDecoder`` (which takes its unfused path off the TPU). The mask
  head's last layer is scaled by 30 so that the attention masks are decisive
  (tests/test_torch_decoder.py does the same).
- The SEGNET tower in training mode: BatchNorm on the batch statistics with
  flax's running-statistics update (the biased variance, momentum 0.9),
  against the JAX ``DilatedResNetFCN(train=True)``: output, running
  statistics and gradients.
- In eval mode the unfused decoder computes what the fused one does.
- The trainer: a non-finite loss keeps the parameters, the running
  statistics and the optimizer state; a fixed batch's loss falls.

Tolerances: outputs 1e-5 (relative to their scale), gradients 1e-4 of each
leaf's largest entry, running statistics 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_threads import module_tmp_cleanup  # noqa: F401
from torch_train_cases import (  # noqa: F401 (few_torch_threads: autouse)
    B, few_torch_threads, scaled_diff, tiny_batch, tiny_configs, to_torch, tree_items,
)
from unseenobjectswithmeanshift_tpu.models.decoder import MeanShiftDecoder as JaxDecoder
from unseenobjectswithmeanshift_tpu.models.resnet import DilatedResNetFCN as JaxFCN
from unseenobjectswithmeanshift_torch.models.decoder import MeanShiftDecoder
from unseenobjectswithmeanshift_torch.models.resnet import DilatedResNetFCN
from unseenobjectswithmeanshift_torch.train.trainer import Trainer, new_model
from unseenobjectswithmeanshift_torch.weights import (
    _predictor, from_jax_segnet_variables, to_jax_variables,
)

E, NH, Q, L, FF, MD, IC, h, w = 32, 4, 6, 2, 32, 24, 16, 12, 16


def _jax_decoder_params(rng):
    x = np.zeros((B, h, w, IC), np.float32)
    mf = np.zeros((B, h, w, MD), np.float32)
    dec = JaxDecoder(hidden_dim=E, num_queries=Q, nheads=NH, dim_feedforward=FF, dec_layers=L,
                     mask_dim=MD, in_channels=IC)
    params = jax.tree.map(np.asarray, dec.init(jax.random.PRNGKey(2), [x], mf))["params"]
    last = params["mask_embed"]["layers_2"]
    last["kernel"], last["bias"] = last["kernel"] * 30, last["bias"] * 30
    return dec, params


def test_unfused_decoder_train_matches_jax(rng):
    jdec, params = _jax_decoder_params(rng)
    x = rng.randn(B, h, w, IC).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    mf = rng.randn(B, h, w, MD).astype(np.float32)
    cot_c = rng.randn(L + 1, B, Q, 3).astype(np.float32)
    cot_e = rng.randn(L + 1, B, Q, MD).astype(np.float32) * 0.1

    def heads(out):
        hs = list(out["aux_outputs"]) + [out]
        return [hd["pred_logits"] for hd in hs], [hd["mask_embed"] for hd in hs]

    def jax_loss(p):
        cls, me = heads(jdec.apply({"params": p}, [x], mf))
        return sum(jnp.sum(c * cot_c[i]) + jnp.sum(m * cot_e[i])
                   for i, (c, m) in enumerate(zip(cls, me))), (cls, me)

    (_, (jcls, jme)), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)

    sd = {}
    _predictor(params, sd)
    dec = MeanShiftDecoder(hidden_dim=E, num_queries=Q, nheads=NH, dim_feedforward=FF,
                           dec_layers=L, mask_dim=MD, in_channels=IC)
    dec.load_state_dict({k.removeprefix("sem_seg_head.predictor."): v for k, v in sd.items()})
    out = dec.forward_unfused(torch.from_numpy(x), torch.from_numpy(mf), remat=True)
    cls, me = heads(out)
    for i in range(L + 1):
        assert scaled_diff(cls[i].detach().numpy(), np.asarray(jcls[i])) <= 1e-5, i
        assert scaled_diff(me[i].detach().numpy(), np.asarray(jme[i])) <= 1e-5, i
    sum((c * torch.from_numpy(cot_c[i])).sum() + (m * torch.from_numpy(cot_e[i])).sum()
        for i, (c, m) in enumerate(zip(cls, me))).backward()
    got = tree_items(to_jax_variables({"sem_seg_head.predictor." + n: p.grad
                                       for n, p in dec.named_parameters()})["params"]["predictor"])
    want = tree_items(jax.tree.map(np.asarray, jgrads))
    assert set(got) == set(want)
    worst = max((scaled_diff(got[k], want[k]), k) for k in want)
    assert worst[0] <= 1e-4, worst


def test_backbone_train_mode_matches_jax(rng):
    x = rng.randn(B, 32, 48, 3).astype(np.float32)
    jfcn = JaxFCN(layers=(1, 1, 1, 1), num_units=8)
    variables = jax.tree.map(np.asarray, jfcn.init(jax.random.PRNGKey(1), x[:1]))
    stats = jax.tree.map(lambda s: s + 0.5, variables["batch_stats"])   # non-trivial start
    cot = rng.randn(B, 32, 48, 8).astype(np.float32)

    def jax_loss(p, xx):
        y, upd = jfcn.apply({"params": p, "batch_stats": stats}, xx, train=True,
                            mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd["batch_stats"])

    (_, (jy, jstats)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(variables["params"], x)

    sd = from_jax_segnet_variables({"params": {"fcn": variables["params"]},
                                    "batch_stats": {"fcn": stats}})
    fcn = DilatedResNetFCN((1, 1, 1, 1), num_units=8)
    fcn.load_state_dict({k.removeprefix("fcn.resnet34_8s."): v for k, v in sd.items()})
    fcn.train()
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = fcn(tx).permute(0, 2, 3, 1)
    assert scaled_diff(y.detach().numpy(), np.asarray(jy)) <= 1e-5
    (y * torch.from_numpy(cot)).sum().backward()
    assert scaled_diff(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jgx)) <= 1e-4

    def prefixed(d):
        return {"pretrained_backbone.fcn.resnet34_8s." + k: v for k, v in d.items()}

    back = to_jax_variables(prefixed(fcn.state_dict()))
    got_stats = tree_items(back["batch_stats"]["pretrained_backbone"]["fcn"])
    want_stats = tree_items(jax.tree.map(np.asarray, jstats))
    assert set(got_stats) == set(want_stats)
    for k in want_stats:
        np.testing.assert_allclose(got_stats[k], want_stats[k], rtol=0, atol=1e-6, err_msg=str(k))
    got = tree_items(to_jax_variables(prefixed(
        {n: p.grad for n, p in fcn.named_parameters()}))["params"]["pretrained_backbone"]["fcn"])
    want = tree_items(jax.tree.map(np.asarray, jgp))
    assert set(got) == set(want)
    worst = max((scaled_diff(got[k], want[k]), k) for k in want)
    assert worst[0] <= 1e-4, worst


def test_unfused_equals_fused_in_eval(rng):
    _, pc = tiny_configs()
    model = new_model(pc, seed=3, device="cpu").eval()
    with torch.no_grad():
        last = model.sem_seg_head.predictor.mask_embed.layers[2]
        last.weight *= 30
        last.bias *= 30
    batch = to_torch(tiny_batch())
    with torch.no_grad():
        fused = model(batch["image"], batch["xyz"], light=False)
        feats, mfeats = model.features(batch["image"], batch["xyz"])
        unfused = model.sem_seg_head.predictor.forward_unfused(feats, mfeats,
                                                               materialize_masks=True)
    for key in ("pred_logits", "mask_embed", "pred_masks"):
        assert scaled_diff(unfused[key].numpy(), fused[key].numpy()) <= 1e-5, key
    for a, b in zip(unfused["aux_outputs"], fused["aux_outputs"]):
        assert scaled_diff(a["pred_logits"].numpy(), b["pred_logits"].numpy()) <= 1e-5


def test_trainer_skips_nonfinite_and_learns():
    _, pc = tiny_configs()
    tr = Trainer(pc, device="cpu", seed=0)
    batch = to_torch(tiny_batch())
    losses = [float(tr.train_step(batch)["total_loss"]) for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    model_before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    opt_before = [v.clone() for s in tr.optimizer.state.values() for v in s.values()]
    bad = dict(batch, image=batch["image"].clone())
    bad["image"][0, 0, 0, 0] = float("nan")
    metrics = tr.train_step(bad)
    assert float(metrics["skipped_nonfinite"]) == 1.0 and tr.step == 5
    assert all(torch.equal(v, tr.model.state_dict()[k]) for k, v in model_before.items())
    assert all(torch.equal(a, b) for a, b in zip(
        opt_before, [v for s in tr.optimizer.state.values() for v in s.values()]))
    assert float(tr.train_step(batch)["skipped_nonfinite"]) == 0.0
