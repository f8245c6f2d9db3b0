"""Standard-backbone (ResNet50 / Swin) training in the port against the JAX package, on the CPU.

Piece by piece, at narrow widths (hidden 48, 4 heads, 6 queries, 3 decoder
layers, 32-channel pixel decoder with one encoder layer) unless a test says
otherwise:

- the decoder's unfused path at 3 levels (the one both packages train),
  under ``torch.utils.checkpoint`` as in training: outputs and every
  gradient, inputs included, against the JAX ``MeanShiftDecoder`` (run
  without ``nn.remat``, which recomputes the same function, to keep its
  compile short), the mask head made decisive (x30);
- the MSDeformAttn core's VJP against ``jax.vjp`` of the JAX core, at
  sampling points away from integer taps (where bilinear weights have
  kinks) and partly outside the maps;
- the three pixel decoders' VJPs;
- Swin-T's VJP at full width at 224 x 224, where the two packages' window
  paddings coincide (LayerNorm eps and merge order set as
  tests/test_torch_swin.py sets them);
- the optimizer: the port's four groups equal JAX's ``_is_backbone`` /
  ``_is_norm_or_embed`` label trees for uoais_resnet50 and tabletop_swin at
  full width, and one AdamW step equals the optax chain;
- ``weights.to_jax_variables`` for both backbones and the three pixel
  decoders (the JAX tree's structure; from_jax_variables inverts it);
- the frozen BatchNorm: the port keeps it frozen in training, where the JAX
  ``ResNetBackbone(train=True)`` normalizes with batch statistics (equal
  under train=False);
- the criterion at stride 4 (mask features at a quarter of the ground
  truth's size): the matcher's costs and every loss term;
- the ``Trainer`` on every standard preset (full width, 32 x 32), its loss
  falling, save / restore / serve, and a bf16 step.

Two GroupNorm / LayerNorm settings differ between the packages on purpose
(ROADMAP.md section 3): where a test runs both on one set of weights it
puts the JAX package's eps on the port's modules.

With UOMS_TRAIN_PARITY=1 two whole train steps run against JAX (the JAX
standard-arch step compiles for minutes on the CPU): tabletop_swin against
JAX's ``Trainer.train_step``, and uoais_resnet50 against a flax composite
that runs the JAX ``ResNetBackbone`` with train=False (frozen BatchNorm)
and the JAX pixel decoder and decoder in train mode.

Tolerances: outputs 1e-5 of their scale; gradients 1e-4 of each leaf's
largest entry (the pixel decoders' leaves floored at 1e-2 of the largest
gradient: worst_gradient; 1e-4 of the model's largest gradient for a
whole step, as tests/test_torch_train_step.py); loss terms 1e-5 relative;
optimizer updates 1e-6 absolute.
"""

import os

import flax.linen as fnn
from flax.traverse_util import flatten_dict, unflatten_dict
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401
from torch_train_cases import jax_draws, scaled_diff, tree_items
from unseenobjectswithmeanshift_tpu.config import get_config as jax_get_config
from unseenobjectswithmeanshift_tpu.losses import matcher as jax_matcher
from unseenobjectswithmeanshift_tpu.losses.criterion import SetCriterion as JaxCriterion
from unseenobjectswithmeanshift_tpu.losses.criterion import loss_masks as jax_loss_masks
from unseenobjectswithmeanshift_tpu.models import pixel_decoders as jax_pd
from unseenobjectswithmeanshift_tpu.models.backbone_resnet import ResNetBackbone as JaxResNet
from unseenobjectswithmeanshift_tpu.models.decoder import MeanShiftDecoder as JaxDecoder
from unseenobjectswithmeanshift_tpu.models.meta_arch import build_model as jax_build_model
from unseenobjectswithmeanshift_tpu.models.swin import SwinTransformer as JaxSwin
from unseenobjectswithmeanshift_tpu.ops import ms_deform_attn as jax_msda
from unseenobjectswithmeanshift_tpu.train import trainer as jax_trainer
from unseenobjectswithmeanshift_torch.config import get_config
from unseenobjectswithmeanshift_torch.losses.criterion import loss_masks
from unseenobjectswithmeanshift_torch.losses.matcher import hungarian_cost_matrix
from unseenobjectswithmeanshift_torch.models import pixel_decoders as pd
from unseenobjectswithmeanshift_torch.models.backbone_resnet import (
    FrozenBatchNorm2d, ResNetBackbone,
)
from unseenobjectswithmeanshift_torch.models.decoder import MeanShiftDecoder
from unseenobjectswithmeanshift_torch.models.meta_arch import build_model
from unseenobjectswithmeanshift_torch.models.swin import SwinTransformer
from unseenobjectswithmeanshift_torch.ops import ms_deform_attn as msda
from unseenobjectswithmeanshift_torch.pipeline.factory import build_two_stage_predictor
from unseenobjectswithmeanshift_torch.train.trainer import (
    Trainer, clip_by_global_norm_, learning_rate, make_optimizer, new_model,
)
from unseenobjectswithmeanshift_torch.utils import checkpoint_io
from unseenobjectswithmeanshift_torch.weights import (
    from_jax_variables, init_random, to_jax_variables,
)

E, NH, Q, FF, MD, C, B, G = 48, 4, 6, 32, 32, 32, 2, 3
JAX_EPS = 1e-6          # flax's GroupNorm / LayerNorm default (the port: 1e-5)
PD = "sem_seg_head.pixel_decoder."
STANDARD_PRESETS = ("tabletop_pretrained_resnet50", "uoais_resnet50", "mixture_resnet50",
                    "crop_mixture_resnet50", "crop_tabletop_resnet50_rgb", "pushing_resnet50",
                    "tabletop_swin")
t = torch.from_numpy


def shrink(cfg, pixel_decoder="msdeformattn"):
    """The narrow standard arch (the backbone keeps its full width)."""
    d, p = cfg.decoder, cfg.pixel_decoder
    d.num_queries, d.hidden_dim, d.dim_feedforward, d.dec_layers, d.nheads = Q, E, FF, 3, NH
    d.mask_dim, d.conv_dim = MD, C
    p.name, p.conv_dim, p.mask_dim, p.transformer_enc_layers = pixel_decoder, C, MD, 1
    cfg.loss.train_num_points, cfg.loss.max_gt_instances = 64, G
    return cfg


def configs(preset="uoais_resnet50", pixel_decoder="msdeformattn"):
    """(JAX config, port config), both narrowed."""
    return (shrink(jax_get_config(preset), pixel_decoder),
            shrink(get_config(preset), pixel_decoder))


def jax_eps(model):
    """The JAX package's eps on the port's GroupNorms and Swin LayerNorms."""
    for m in model.modules():
        if isinstance(m, torch.nn.GroupNorm):
            m.eps = JAX_EPS
        if isinstance(m, SwinTransformer):
            for sub in m.modules():
                if isinstance(sub, torch.nn.LayerNorm):
                    sub.eps = JAX_EPS
    return model


def batch_of(rng, hw=(64, 64), batch=B):
    """Images in [0, 255), 2 instances in the first 2 of G slots."""
    H, W = hw
    masks = np.zeros((batch, G, H, W), np.float32)
    masks[:, 0, 4:H // 2, 6:W // 2] = 1
    masks[:, 1, H // 2 + 2:H - 4, W // 3:W - 6] = 1
    return {"image": (rng.rand(batch, H, W, 3) * 255).astype(np.float32),
            "gt_labels": np.ones((batch, G), np.int32), "gt_masks": masks,
            "gt_valid": np.tile([True, True, False], (batch, 1))}


def to_torch(batch):
    return {k: t(np.array(v)) for k, v in batch.items()}


def flat_shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat_shapes(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(v.shape)
    return out


def worst_leaf(got, want, floor=0.0):
    """The largest max |got - want| over a leaf's largest |want| (at least
    floor), and its leaf."""
    assert set(got) == set(want), set(got) ^ set(want)
    return max((float(np.abs(got[k] - want[k]).max())
                / max(float(np.abs(want[k]).max()), floor, 1e-30), k) for k in want)


def worst_gradient(got, want):
    """worst_leaf with each leaf's scale floored at 1e-2 of the largest
    gradient entry of the whole tree: a bias ahead of a 32-group GroupNorm
    of 32 channels, or a softmax attention's key bias, has a gradient of
    exactly zero, which both packages compute as rounding noise (1e-7 of
    the largest gradient, measured)."""
    top = max(float(np.abs(w).max()) for w in want.values())
    return worst_leaf(got, want, 1e-2 * top)


def test_three_level_decoder_train_matches_jax(rng):
    IC, levels, mf_hw = 16, [(2, 3), (4, 6), (8, 12)], (16, 24)
    xs = [rng.randn(B, h, w, IC).astype(np.float32) for h, w in levels]
    mf = rng.randn(B, *mf_hw, MD).astype(np.float32)
    dec = init_random(MeanShiftDecoder(hidden_dim=E, num_queries=Q, nheads=NH,
                                       dim_feedforward=FF, dec_layers=3, mask_dim=MD,
                                       in_channels=IC, num_feature_levels=3),
                      torch.Generator().manual_seed(2))
    with torch.no_grad():
        last = dec.mask_embed.layers[2]
        last.weight *= 30
        last.bias *= 30
    params = to_jax_variables({"sem_seg_head.predictor." + k: v
                               for k, v in dec.state_dict().items()})["params"]["predictor"]
    jdec = JaxDecoder(hidden_dim=E, num_queries=Q, nheads=NH, dim_feedforward=FF, dec_layers=3,
                      mask_dim=MD, in_channels=IC, num_feature_levels=3)
    cot_c = rng.randn(4, B, Q, 3).astype(np.float32)
    cot_e = rng.randn(4, B, Q, MD).astype(np.float32) * 0.1

    def heads(out):
        hs = list(out["aux_outputs"]) + [out]
        return [hd["pred_logits"] for hd in hs], [hd["mask_embed"] for hd in hs]

    def jax_loss(p, xs):
        cls, me = heads(jdec.apply({"params": p}, xs, mf))
        return sum(jnp.sum(c * cot_c[i]) + jnp.sum(m * cot_e[i])
                   for i, (c, m) in enumerate(zip(cls, me))), (cls, me)

    (_, (jcls, jme)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(params, xs)

    txs = [t(x).requires_grad_() for x in xs]
    out = dec.forward_unfused(txs, t(mf), remat=True)
    cls, me = heads(out)
    assert len(cls) == 4
    for i in range(4):
        assert scaled_diff(cls[i].detach().numpy(), np.asarray(jcls[i])) <= 1e-5, i
        assert scaled_diff(me[i].detach().numpy(), np.asarray(jme[i])) <= 1e-5, i
    sum((c * t(cot_c[i])).sum() + (m * t(cot_e[i])).sum()
        for i, (c, m) in enumerate(zip(cls, me))).backward()
    got = tree_items(to_jax_variables({"sem_seg_head.predictor." + n: p.grad
                                       for n, p in dec.named_parameters()})["params"]["predictor"])
    worst = worst_gradient(got, tree_items(jax.tree.map(np.asarray, jgp)))
    assert worst[0] <= 1e-4, worst
    for level, (a, b) in enumerate(zip(txs, jgx)):
        assert scaled_diff(a.grad.numpy(), np.asarray(b)) <= 1e-4, level


def _off_tap_locations(rng, shapes, lead):
    """Normalized (x, y) locations [*lead, L, P, 2] whose pixel coordinates
    (loc * size - 0.5) sit 0.15-0.85 past an integer, from one pixel
    outside each map to one past its far edge."""
    L = len(shapes)
    loc = np.empty(lead + (L, 3, 2), np.float32)
    for lvl, (h, w) in enumerate(shapes):
        for axis, n in ((0, w), (1, h)):
            px = rng.randint(-1, n + 1, lead + (3,)) + rng.uniform(0.15, 0.85, lead + (3,))
            loc[..., lvl, :, axis] = (px + 0.5) / n
    return loc


def test_ms_deform_attn_core_vjp_matches_jax(rng):
    shapes = [(3, 5), (6, 4), (2, 2)]
    NHd, D, Lq = 4, 8, 7
    value = rng.randn(B, sum(h * w for h, w in shapes), NHd, D).astype(np.float32)
    loc = _off_tap_locations(rng, shapes, (B, Lq, NHd))
    aw = rng.rand(B, Lq, NHd, len(shapes), 3).astype(np.float32)
    cot = rng.randn(B, Lq, NHd * D).astype(np.float32)
    @jax.jit
    def jax_vjp(v, lc, a, c):
        out, vjp = jax.vjp(lambda *x: jax_msda.ms_deform_attn_core(x[0], shapes, *x[1:]),
                           v, lc, a)
        return out, vjp(c)

    want, jgrads = jax_vjp(value, loc, aw, cot)
    inputs = [t(x).requires_grad_() for x in (value, loc, aw)]
    got = msda.ms_deform_attn_core(inputs[0], shapes, *inputs[1:])
    (got * t(cot)).sum().backward()
    assert scaled_diff(got.detach().numpy(), np.asarray(want)) <= 1e-5
    for name, x, g in zip(("value", "sampling_locations", "attention_weights"), inputs,
                          jgrads):
        assert scaled_diff(x.grad.numpy(), np.asarray(g)) <= 1e-5, name


@pytest.mark.parametrize("name", ["msdeformattn", "fpn", "transformer_enc"])
def test_pixel_decoder_vjp_matches_jax(rng, name):
    """The port's init carried to JAX, and its gradients read back, by
    to_jax_variables. GroupNorm scales and biases off identity; the
    deformable attention's offset kernels random (the init zeroes them,
    which puts every sampling point on an integer tap)."""
    ch = (32, 64, 96, 128)
    feats = {f"res{i + 2}": rng.randn(1, 16 >> i, 24 >> i, c).astype(np.float32)
             for i, c in enumerate(ch)}
    if name == "msdeformattn":
        jm = jax_pd.MSDeformAttnPixelDecoder(ch, conv_dim=C, mask_dim=MD, enc_layers=1)
        m = pd.MSDeformAttnPixelDecoder(ch, C, MD, enc_layers=1)
    elif name == "fpn":
        jm = jax_pd.BasePixelDecoder(ch, conv_dim=C, mask_dim=MD)
        m = pd.BasePixelDecoder(ch, C, MD)
    else:
        jm = jax_pd.TransformerEncoderPixelDecoder(ch, conv_dim=C, mask_dim=MD, enc_layers=1,
                                                   nheads=4, dim_feedforward=64)
        m = pd.TransformerEncoderPixelDecoder(ch, C, MD, enc_layers=1, nheads=4,
                                              dim_feedforward=64)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    init_random(m, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for sub in m.modules():
            if isinstance(sub, torch.nn.GroupNorm):
                sub.weight.uniform_(0.5, 1.5, generator=gen)
                sub.bias.uniform_(-0.5, 0.5, generator=gen)
            if isinstance(sub, msda.MSDeformAttn):
                sub.sampling_offsets.weight.normal_(0, 0.3, generator=gen)
    params = to_jax_variables({PD + k: v for k, v in m.state_dict().items()}
                              )["params"]["pixel_decoder"]
    m = jax_eps(m)

    def flat(o):
        return [o[0]] + ([] if o[1] is None else [o[1]]) + list(o[2])

    tfeats = {k: t(v).permute(0, 3, 1, 2).requires_grad_() for k, v in feats.items()}
    got = [o.permute(0, 2, 3, 1) for o in flat(m(tfeats))]
    cots = [rng.randn(*o.shape).astype(np.float32) for o in got]

    def jax_loss(p, f):
        outs = flat(jm.apply({"params": p}, f))
        return sum(jnp.sum(a * b) for a, b in zip(outs, cots)), outs

    (_, outs), (jgp, jgx) = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1),
                                                       has_aux=True))(params, jfeats)
    assert len(got) == len(outs) == (4 if name == "fpn" else 5)
    for g, w in zip(got, outs):
        assert scaled_diff(g.detach().numpy(), np.asarray(w)) <= 1e-5
    sum((g * t(c)).sum() for g, c in zip(got, cots)).backward()
    grads = to_jax_variables({PD + n: p.grad for n, p in m.named_parameters()})
    worst = worst_gradient(tree_items(grads["params"]["pixel_decoder"]),
                           tree_items(jax.tree.map(np.asarray, jgp)))
    assert worst[0] <= 1e-4, worst
    for k, x in tfeats.items():
        assert scaled_diff(x.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jgx[k])) <= 1e-4, k


def test_swin_vjp_matches_jax(rng):
    """Swin-T at full width and depth, 224 x 224: the gradients go through
    the relative-position-bias gather, the shifted-window mask and the patch
    merging; the port's weights reach JAX through to_jax_variables."""
    m = jax_eps(init_random(SwinTransformer(), torch.Generator().manual_seed(0)))
    with torch.no_grad():
        for sub in m.modules():
            if isinstance(sub, torch.nn.LayerNorm):
                sub.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
    params = to_jax_variables({f"backbone.{k}": v for k, v in m.state_dict().items()}
                              )["params"]["backbone"]
    x = rng.randn(1, 224, 224, 3).astype(np.float32)
    cots = {f"res{i + 2}": rng.randn(1, 56 >> i, 56 >> i, c).astype(np.float32)
            for i, c in enumerate((96, 192, 384, 768))}

    def jax_loss(p, xx):
        out = JaxSwin().apply({"params": p}, xx)
        return sum(jnp.sum(out[k] * cots[k]) for k in cots)

    jgp, jgx = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(params, jnp.asarray(x))
    tx = t(x).permute(0, 3, 1, 2).requires_grad_()
    out = m(tx)
    sum((out[k].permute(0, 2, 3, 1) * t(c)).sum() for k, c in cots.items()).backward()
    grads = to_jax_variables({f"backbone.{n}": p.grad for n, p in m.named_parameters()})
    worst = worst_gradient(tree_items(grads["params"]["backbone"]),
                           tree_items(jax.tree.map(np.asarray, jgp)))
    assert worst[0] <= 1e-4, worst
    assert scaled_diff(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jgx)) <= 1e-4


@pytest.mark.parametrize("preset", ["uoais_resnet50", "tabletop_swin"])
def test_optimizer_groups_equal_jax_labels(preset):
    """Full width. Each parameter's group (backbone multiplier or not,
    decayed or not) carried to the JAX layout by to_jax_variables equals
    JAX's labels of the same leaf; the leaves are the JAX model's, less the
    ResNet50's BatchNorm scales and biases (frozen buffers in the port)."""
    cfg = get_config(preset)
    with torch.device("meta"):
        model = build_model(cfg)
    opt = make_optimizer(model, cfg)
    # the ResNet50 has no backbone parameter without decay: its BatchNorm
    # is buffers
    assert len(opt.param_groups) == (3 if preset == "uoais_resnet50" else 4)
    code = {}
    for g in opt.param_groups:
        for p in g["params"]:
            code[id(p)] = 2 * (g["multiplier"] != 1.0) + (g["weight_decay"] > 0)
    labels = to_jax_variables({n: torch.full(p.shape, float(code[id(p)]))
                               for n, p in model.named_parameters()})["params"]
    got = {}
    for k, v in tree_items(labels).items():
        assert (v == v.flat[0]).all(), k
        got[k] = int(v.flat[0])
    want = {k: 2 * jax_trainer._is_backbone(k) + (not jax_trainer._is_norm_or_embed(k))
            for k in got}
    assert got == want
    shapes = jax.eval_shape(lambda: jax_build_model(jax_get_config(preset)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    jax_leaves = flat_shapes(shapes["params"])
    frozen = {k for k in jax_leaves if "bn" in k[-2]}
    assert set(jax_leaves) - frozen == set(got)
    assert bool(frozen) == (preset == "uoais_resnet50")
    assert {k: jax_leaves[k] for k in got} == flat_shapes(labels)


def test_adamw_step_matches_optax_chain_standard():
    """One step (global norm 3.0, clipped to 0.01) on identical gradients,
    on the narrow uoais_resnet50's tree with a one-block-per-stage ResNet
    (tests/test_torch_train_optimizer.py holds more steps and norms on the
    UCN arch's tree)."""
    jc, pc = configs()
    with torch.device("meta"):
        model = build_model(pc)
        model.backbone = ResNetBackbone(layers=(1, 1, 1, 1))
    model = init_random(model.to_empty(device="cpu"), torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    opt = make_optimizer(model, pc)
    tx = jax_trainer.make_optimizer(jc)
    jparams = jax.tree.map(np.array, to_jax_variables(
        {n: p.detach() for n, p in params.items()})["params"])
    state = jax.jit(tx.init)(jparams)

    @jax.jit
    def jax_step(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    gen = torch.Generator().manual_seed(0)
    for step, norm in enumerate((3.0,)):
        g = {n: torch.randn(p.shape, generator=gen) for n, p in params.items()}
        total = float(torch.linalg.vector_norm(torch.stack([x.norm() for x in g.values()])))
        g = {n: x * np.float32(norm / total) for n, x in g.items()}
        jparams, state = jax_step(to_jax_variables(g)["params"], state, jparams)
        for n, p in params.items():
            p.grad = g[n].clone()
        grads = [p.grad for p in params.values()]
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        clip_by_global_norm_(grads, gnorm, float(gnorm), pc.solver.clip_gradients)
        for group in opt.param_groups:
            group["lr"] = learning_rate(pc, step) * group["multiplier"]
        opt.step()
        got = tree_items(to_jax_variables({n: p.detach() for n, p in params.items()})["params"])
        want = tree_items(jax.tree.map(np.asarray, jparams))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=str(k))


@pytest.mark.parametrize("preset,pixel_decoder", [
    ("uoais_resnet50", "msdeformattn"), ("tabletop_swin", "msdeformattn"),
    ("uoais_resnet50", "fpn"), ("uoais_resnet50", "transformer_enc")])
def test_to_jax_variables_round_trip(preset, pixel_decoder):
    """A state_dict (random frozen-BatchNorm statistics) -> the JAX tree,
    whose structure and shapes are the JAX model's (params and
    batch_stats) -> from_jax_variables gives it back bit for bit."""
    jc, pc = configs(preset, pixel_decoder)
    model = new_model(pc, seed=1, device="cpu")
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var", "norm.weight", "norm.bias")):
                buf.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(2))
    sd = model.state_dict()
    tree = to_jax_variables(sd)
    shapes = jax.eval_shape(lambda: jax_build_model(jc).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    assert flat_shapes(tree) == flat_shapes(dict(shapes))
    back = from_jax_variables(tree)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_jax_resnet_trains_batchnorm_the_port_keeps_it_frozen(rng):
    """The decision recorded in ROADMAP.md section 3: the port's ResNet50
    BatchNorm is frozen in training (detectron2's FrozenBatchNorm2d, the
    reference's and the published checkpoints' layout); the JAX module
    normalizes with batch statistics under train=True and updates them.
    Under train=False the two compute one function (a one-block-per-stage
    ResNet, random statistics)."""
    m = init_random(ResNetBackbone(layers=(1, 1, 1, 1)), torch.Generator().manual_seed(1))
    with torch.no_grad():
        for k, buf in m.named_buffers():
            if k.endswith("running_mean"):
                buf.normal_(0, 0.1, generator=torch.Generator().manual_seed(2))
            elif k.endswith("running_var"):
                buf.uniform_(0.5, 2.0, generator=torch.Generator().manual_seed(3))
    variables = to_jax_variables({f"backbone.{k}": v for k, v in m.state_dict().items()})
    variables = {c: v["backbone"] for c, v in variables.items()}
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    m.train()
    got = {k: v.permute(0, 2, 3, 1).detach().numpy()
           for k, v in m(t(x).permute(0, 3, 1, 2)).items()}
    assert all(torch.equal(v, m.state_dict()[k]) for k, v in before.items())
    jm = JaxResNet(layers=(1, 1, 1, 1))
    frozen = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, x)
    trained, upd = jax.jit(lambda v, xx: jm.apply(v, xx, train=True, mutable=["batch_stats"]))(
        variables, x)
    for k in got:
        assert scaled_diff(got[k], np.asarray(frozen[k])) <= 1e-5, k
        assert scaled_diff(got[k], np.asarray(trained[k])) > 1e-2, k
    moved = worst_leaf(tree_items(jax.tree.map(np.asarray, upd["batch_stats"])),
                       tree_items(variables["batch_stats"]))
    assert moved[0] > 1e-2


def test_frozen_batchnorm_after_a_train_step(rng):
    """After a step the frozen BatchNorm's buffers are unchanged and no
    parameter of it exists (no gradient, no optimizer entry); the backbone's
    convolutions trained, in the lr x backbone_multiplier groups."""
    _, pc = configs()
    tr = Trainer(pc, device="cpu", seed=0)
    frozen = {f"{mn}.{bn}": b.clone() for mn, m in tr.model.named_modules()
              if isinstance(m, FrozenBatchNorm2d) for bn, b in m.named_buffers()}
    assert len(frozen) == 4 * 53
    convs = {n: p.detach().clone() for n, p in tr.model.named_parameters()
             if n.startswith("backbone.")}
    tr.train_step(to_torch(batch_of(rng)))
    state = tr.model.state_dict()
    assert all(torch.equal(b, state[n]) for n, b in frozen.items())
    assert not any(isinstance(m, FrozenBatchNorm2d) for n, m in tr.model.named_modules()
                   if list(m.parameters(recurse=False)))
    assert all(not torch.equal(p, state[n]) for n, p in convs.items())
    bb = [g for g in tr.optimizer.param_groups if g["multiplier"] != 1.0]
    assert {id(p) for g in bb for p in g["params"]} == {
        id(p) for n, p in tr.model.named_parameters() if n.startswith("backbone.")}


def test_criterion_at_stride_4_matches_jax(rng):
    """mask_features at 16 x 20 against ground truth at 64 x 80: the
    matcher's cost matrices on one draw of points, and the point-sampled
    mask losses of a matching (factored form) with their gradients with
    respect to mask_embed and mask_features, on the JAX draws."""
    Bc, Gc, P = 2, 5, 40
    mf = rng.randn(Bc, 16, 20, 8).astype(np.float32) * 0.5
    me = rng.randn(Bc, Q, 8).astype(np.float32) * 0.5
    logits = rng.randn(Bc, Q, 3).astype(np.float32)
    gt = (rng.rand(Bc, Gc, 64, 80) > 0.6).astype(np.float32)
    valid = np.zeros((Bc, Gc), bool)
    valid[0, :3] = valid[1, :1] = True
    gt[~valid] = 0
    labels = rng.randint(0, 2, (Bc, Gc)).astype(np.int32)

    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda *a: jax_matcher.hungarian_cost_matrix(
        key, a[0], None, a[1], a[2], a[3], P, mask_embed=a[4], mask_features=a[5]))(
        logits, labels, gt, valid, me, mf)
    points = np.concatenate([np.asarray(jax.random.uniform(k, (1, P, 2)))
                             for k in jax.random.split(key, Bc)])
    got = hungarian_cost_matrix(t(logits), None, t(labels), t(gt), t(points),
                                mask_embed=t(me), mask_features=t(mf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    matched = np.stack([rng.permutation(Q)[:Gc] for _ in range(Bc)]).astype(np.int32)
    num_masks = float(valid.sum())

    def jax_losses(e, f):
        out = jax_loss_masks(key, None, gt, valid, matched, num_masks, P, 3.0, 0.75,
                             mask_embed=e, mask_features=f)
        return out["loss_mask"] + out["loss_dice"], out

    (_, jl), (jge, jgf) = jax.jit(jax.value_and_grad(jax_losses, argnums=(0, 1),
                                                     has_aux=True))(me, mf)
    k1, k2 = jax.random.split(key)
    coords = t(np.asarray(jax.random.uniform(k1, (Bc * Gc, 3 * P, 2))))
    rand = t(np.asarray(jax.random.uniform(k2, (Bc * Gc, P - int(0.75 * P), 2))))
    te, tf = t(me).requires_grad_(), t(mf).requires_grad_()
    lm = loss_masks(None, t(gt), t(valid), t(matched).long(), torch.tensor(num_masks), P, 3.0,
                    0.75, coords, rand, mask_embed=te, mask_features=tf)
    (lm["loss_mask"] + lm["loss_dice"]).backward()
    for name in ("loss_mask", "loss_dice"):
        np.testing.assert_allclose(float(lm[name]), float(jl[name]), rtol=1e-5, err_msg=name)
    assert scaled_diff(te.grad.numpy(), np.asarray(jge)) <= 1e-5
    assert scaled_diff(tf.grad.numpy(), np.asarray(jgf)) <= 1e-5


@pytest.mark.parametrize("preset", STANDARD_PRESETS)
def test_trainer_steps_every_standard_preset(rng, preset):
    """The preset as it is (full width), one step at 32 x 32 on the CPU:
    finite losses of every head (1 + 9 decoder layers), no skip."""
    cfg = get_config(preset)
    tr = Trainer(cfg, device="cpu", seed=0)
    batch = to_torch(batch_of(rng, hw=(32, 32), batch=1))
    if cfg.use_depth:
        batch["xyz"] = torch.rand(1, 32, 32, 3)
    metrics = tr.train_step(batch)
    assert float(metrics["skipped_nonfinite"]) == 0.0
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert len([k for k in metrics if k.startswith("loss_ce")]) == 10


def test_standard_trainer_learns_saves_restores_and_serves(rng, tmp_path):
    """uoais_resnet50 (narrow): the train outputs (pred_logits, mask_embed
    and the stride-4 mask_features, one aux head per decoder layer, no
    backbone_features); the loss on a fixed batch falls over three steps; a
    checkpoint restores to equal weights, optimizer state and step, and
    serves through build_two_stage_predictor with the crop preset the
    factory pairs with it."""
    _, pc = configs()
    batch = to_torch(batch_of(rng))
    tr = Trainer(pc, device="cpu", seed=0)
    with torch.no_grad():
        out = tr.model(batch["image"], train=True)
    assert out["mask_features"].shape == (B, 16, 16, MD)
    assert out["mask_embed"].shape == (B, Q, MD) and out["pred_logits"].shape == (B, Q, 3)
    assert len(out["aux_outputs"]) == pc.decoder.dec_layers
    assert "backbone_features" not in out and "pred_masks" not in out
    losses = [float(tr.train_step(batch)["total_loss"]) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    path = checkpoint_io.save(checkpoint_io.checkpoint_path(str(tmp_path), tr.step), tr)
    fresh = Trainer(pc, device="cpu", seed=1)
    assert checkpoint_io.restore(path, fresh) == 3
    sa, sb = tr.state_dict(), fresh.state_dict()
    assert all(torch.equal(v, sb["model"][k]) for k, v in sa["model"].items())
    opt_a, opt_b = sa["optimizer"]["state"], sb["optimizer"]["state"]
    assert opt_a.keys() == opt_b.keys() and len(opt_a) == len(list(tr.model.parameters()))
    assert all(torch.equal(v, opt_b[i][n]) for i, s in opt_a.items() for n, v in s.items())
    crop = shrink(get_config("crop_tabletop_resnet50_rgb"))
    pred = build_two_stage_predictor("uoais_resnet50", cfg=pc, cfg_crop=crop, checkpoint=path,
                                     device="cpu")
    assert pred.cfg_crop.name == "crop_tabletop_resnet50_rgb"
    for served in (pred.model, pred.model_crop):
        assert all(torch.equal(v, served.state_dict()[k]) for k, v in sa["model"].items())
    labels, refined = pred(batch["image"][:1])
    assert labels.shape == refined.shape == (1, 64, 64)
    assert labels.dtype == refined.dtype == torch.int32


def test_bf16_standard_step(rng):
    """A bf16 step of the narrow uoais_resnet50 against fp32 on the same
    weights: the backbone and decoder compute in bf16, the MSDeformAttn
    pixel decoder in fp32 (pixel_decoder.fp32), and the gradient crosses
    that cast back into the bf16 backbone: every parameter gets a finite
    gradient, the backbone's nonzero. The first total loss within 5e-2 of
    fp32's."""
    _, pc = configs()
    batch = to_torch(batch_of(rng))
    tr32 = Trainer(pc, device="cpu", seed=0)
    pc16 = shrink(get_config("uoais_resnet50"))
    pc16.dtype = "bfloat16"
    model16 = new_model(pc16, seed=0, device="cpu")
    model16.load_state_dict(tr32.model.state_dict())
    tr16 = Trainer(pc16, device="cpu", seed=0, model=model16)
    feats = model16.backbone_features(batch["image"])
    assert feats["res2"].dtype == torch.bfloat16
    mf, _, ms = model16.sem_seg_head.pixel_decoder(feats)
    assert mf.dtype == ms[0].dtype == torch.bfloat16
    total32, _ = tr32.gradients(batch)
    total16, _ = tr16.gradients(batch)
    assert abs(float(total16) - float(total32)) <= 5e-2 * abs(float(total32))
    for n, p in model16.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None, n
        assert bool(torch.isfinite(p.grad).all()), n
    assert all(float(p.grad.abs().max()) > 0 for n, p in model16.named_parameters()
               if n.startswith("backbone.") and n.endswith("conv1.weight"))


# --- whole train steps against the JAX package, gated (minutes of JAX compile) ---

parity = pytest.mark.skipif(
    os.environ.get("UOMS_TRAIN_PARITY") != "1",
    reason="the JAX standard-arch train step compiles for minutes; set UOMS_TRAIN_PARITY=1")
GRAD_SCALE = 2.0 ** 20


def off_taps(model):
    """The MSDeformAttn offset kernels drawn from N(0, 0.3^2): the init
    zeroes them, which puts every sampling point exactly on an integer tap,
    where the sample has no derivative in the location and each package's
    rounding of loc * size - 0.5 picks a side, so the two packages'
    gradients of the offset kernels need not agree there."""
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, msda.MSDeformAttn):
                m.sampling_offsets.weight.normal_(0, 0.3, generator=gen)
    return model


def _whole_step_gradients(model, pc, batch, key):
    """The port's loss terms and gradients (in the JAX layout) of one train
    step on the JAX criterion's draws."""
    tr = Trainer(pc, device="cpu", model=model)
    draws = jax_draws(key, 1 + pc.decoder.dec_layers, B, B * G, pc.loss.train_num_points)
    total, losses = tr.gradients(to_torch(batch), draws)
    grads = tree_items(to_jax_variables({n: p.grad for n, p in model.named_parameters()
                                         if p.grad is not None})["params"])
    return tr, draws, float(total), {k: float(v) for k, v in losses.items()}, grads


def _assert_step(losses, total, jmetrics, grads, jgrads):
    for name, value in losses.items():
        np.testing.assert_allclose(value, float(jmetrics[name]), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    np.testing.assert_allclose(total, float(jmetrics["total_loss"]), rtol=1e-5)
    assert set(grads) == set(jgrads)
    scale = max(float(np.abs(g).max()) for g in jgrads.values())
    worst = max((float(np.abs(grads[k] - jgrads[k]).max()) / scale, k) for k in jgrads)
    assert worst[0] <= 1e-4, worst


@parity
def test_swin_train_step_matches_jax(rng):
    """tabletop_swin (narrow decoder, full Swin-T) at 224 x 224 against the
    JAX ``Trainer.train_step``, its optimizer replaced by a scale of 2^20 so
    that params + 2^20 g gives the raw gradients. ``init_state`` gives a
    model without BatchNorm an empty ``FrozenDict`` of batch statistics, on
    which the JAX train step fails (tree structures dict / FrozenDict,
    ROADMAP.md section 3): the test passes a plain dict. The deformable
    attention's offset kernels are drawn off zero (off_taps)."""
    jc, pc = configs("tabletop_swin")
    batch = batch_of(rng, hw=(224, 224))
    jtr = jax_trainer.Trainer(jc)
    state = jtr.init_state(jax.random.PRNGKey(0), (224, 224), batch_size=B)
    jtr.tx = optax.scale(GRAD_SCALE)
    params = jax.tree.map(np.array, state.params)
    for name, leaf in params["pixel_decoder"].items():
        if name.startswith("encoder_layer"):
            so = leaf["self_attn"]["sampling_offsets"]
            so["kernel"] = rng.normal(0, 0.3, so["kernel"].shape).astype(np.float32)
    state = state.replace(params=params, opt_state=jtr.tx.init(params), batch_stats={})
    key = jax.random.PRNGKey(3)
    new_state, metrics = jax.jit(jtr.train_step)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    old = tree_items(jax.tree.map(np.asarray, state.params))
    new = tree_items(jax.tree.map(np.asarray, new_state.params))
    jgrads = {k: (new[k] - old[k]) / GRAD_SCALE for k in old}

    model = jax_eps(build_model(pc))
    model.load_state_dict(from_jax_variables({"params": jax.tree.map(np.asarray,
                                                                      state.params)}))
    _, _, total, losses, grads = _whole_step_gradients(model, pc, batch, key)
    _assert_step(losses, total, metrics, grads, jgrads)


class FrozenBNStandard(fnn.Module):
    """JAX's StandardMaskFormer train forward (meta_arch.py:183-261) with
    its ResNetBackbone run at train=False: the port's frozen BatchNorm."""

    cfg: object

    @fnn.compact
    def __call__(self, image):
        from unseenobjectswithmeanshift_tpu.config import COCO_PIXEL_MEAN_RGB, COCO_PIXEL_STD_RGB

        c, d, p = self.cfg, self.cfg.decoder, self.cfg.pixel_decoder
        x = (image - jnp.asarray(COCO_PIXEL_MEAN_RGB)) / jnp.asarray(COCO_PIXEL_STD_RGB)
        feats = JaxResNet(name="backbone")(x, train=False)
        mf, _, ms = jax_pd.MSDeformAttnPixelDecoder(
            feature_channels=(256, 512, 1024, 2048), conv_dim=p.conv_dim, mask_dim=p.mask_dim,
            enc_layers=p.transformer_enc_layers, name="pixel_decoder")(feats)
        out = JaxDecoder(
            num_classes=d.num_classes, hidden_dim=d.hidden_dim, num_queries=d.num_queries,
            nheads=d.nheads, dim_feedforward=d.dim_feedforward, dec_layers=d.dec_layers,
            mask_dim=d.mask_dim, in_channels=p.conv_dim, num_feature_levels=3,
            decoder_block_norm=d.decoder_block_norm, kappa=d.kappa,
            remat=c.train_remat_attention, name="predictor")(ms, mf)
        out["mask_features"] = mf
        return out


@parity
def test_resnet50_train_step_matches_jax_composite(rng):
    """uoais_resnet50 (narrow decoder and pixel decoder, full ResNet50) at
    64 x 64 against FrozenBNStandard under JAX's criterion, differentiated
    with respect to the port's parameters only (the BatchNorm scales and
    biases held fixed), so that the 0.01 global-norm clip sees the same
    gradients: loss terms, every gradient, the global norm, and the
    parameters after JAX's optax chain against the port's train_step."""
    jc, pc = configs()
    batch = batch_of(rng)
    model = off_taps(jax_eps(new_model(pc, seed=0, device="cpu")))
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 2.0, generator=torch.Generator().manual_seed(4))
    variables = to_jax_variables(model.state_dict())
    flat = flatten_dict(variables["params"])
    frozen = {k: v for k, v in flat.items() if k[0] == "backbone" and "bn" in k[-2]}
    trainable = unflatten_dict({k: v for k, v in flat.items() if k not in frozen})
    composite = FrozenBNStandard(jc)
    crit = JaxCriterion(num_points=jc.loss.train_num_points)
    key = jax.random.PRNGKey(3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        params = unflatten_dict({**flatten_dict(p), **frozen})
        out = composite.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jbatch["image"])
        return crit(key, out, jbatch["gt_labels"], jbatch["gt_masks"], jbatch["gt_valid"])

    tx = jax_trainer.make_optimizer(jc)

    @jax.jit
    def jax_step(p):
        (total, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return total, losses, grads, optax.global_norm(grads), optax.apply_updates(p, updates)

    jtotal, jlosses, jgrads, jnorm, jnew = jax_step(trainable)
    tr, draws, total, losses, grads = _whole_step_gradients(model, pc, batch, key)
    _assert_step(losses, total, dict(jlosses, total_loss=jtotal), grads,
                 tree_items(jax.tree.map(np.asarray, jgrads)))
    metrics = tr.train_step(to_torch(batch), draws)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jnorm), rtol=1e-4)
    got = tree_items(to_jax_variables({n: p.detach()
                                       for n, p in model.named_parameters()})["params"])
    want = tree_items(jax.tree.map(np.asarray, jnew))
    g = tree_items(jax.tree.map(np.asarray, jgrads))
    for k in want:
        # Adam's first step is lr * g / (|g| + eps): where a gradient entry
        # is at the level of fp32 rounding its sign is not defined, so only
        # entries above 1e-3 of their leaf's largest are held
        sure = np.abs(g[k]) > 1e-3 * np.abs(g[k]).max()
        np.testing.assert_allclose(got[k][sure], want[k][sure], rtol=0, atol=1e-6,
                                   err_msg=str(k))
