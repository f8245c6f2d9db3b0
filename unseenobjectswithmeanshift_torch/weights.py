"""Weights: JAX variable trees to the port's state_dict, and seeded random init.

``from_jax_variables`` is the inverse of the JAX package's
``utils.checkpoint.convert_msmformer_checkpoint`` for the UCN-backbone
MSMFormer: it takes the ``{"params": ..., "batch_stats": ...}`` tree as numpy
arrays and returns a state_dict with the reference checkpoint's key names,
which ``MSMFormer.load_state_dict`` accepts as it is.
``from_jax_segnet_variables`` does the same for the UCN SEGNET alone, the
inverse of ``utils.checkpoint.convert_ucn_checkpoint``. Both take every SEGNET
variant: one tower (``fcn``: COLOR, DEPTH, 'early' with a 6-channel conv1)
or two (``fcn`` and ``fcn_depth``: 'add', 'cat'). ``load_npz_variables``
reads such a tree back from the ``.npz`` that ``scripts/export_release_npz.py``
writes from a committed release, with numpy alone. ``load_reference_checkpoint``
reads a reference ``.pth`` (the published UCN and MSMFormer checkpoints) into
a state_dict of the port's modules, and ``fuse_tower_state`` fuses a
two-tower state_dict into the grouped layout (``SEGNET.grouped_towers``).

``to_jax_variables`` goes the other way for both archs (a state_dict, or
gradients by parameter name, to the JAX tree).

Layouts: flax conv [kh, kw, in, out] -> torch [out, in, kh, kw];
Dense [in, out] -> Linear [out, in]; the q/k/v kernels are packed into
``in_proj_weight`` [3E, E]; batch_stats become BatchNorm buffers.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
import torch.nn as nn


def _t(w):
    return torch.from_numpy(np.array(w))      # a writable copy


def _conv(w):
    return _t(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def _dense(w):
    return _t(np.asarray(w).T)


def _backbone(params, stats, prefix, sd):
    """One SEGNET tower subtree (conv1, bn1, layerN_b, fc)."""
    def bn(p, s, key):
        sd[key + ".weight"] = _t(p["scale"])
        sd[key + ".bias"] = _t(p["bias"])
        sd[key + ".running_mean"] = _t(s["mean"])
        sd[key + ".running_var"] = _t(s["var"])
        sd[key + ".num_batches_tracked"] = torch.tensor(0)

    sd[prefix + "conv1.weight"] = _conv(params["conv1"]["kernel"])
    bn(params["bn1"], stats["bn1"], prefix + "bn1")
    for name in params:
        m = re.fullmatch(r"layer(\d+)_(\d+)", name)
        if not m:
            continue
        key = f"{prefix}layer{m.group(1)}.{m.group(2)}."
        p, s = params[name], stats[name]
        for conv in ("conv1", "conv2"):
            sd[key + conv + ".weight"] = _conv(p[conv]["kernel"])
        for b in ("bn1", "bn2"):
            bn(p[b], s[b], key + b)
        if "downsample_conv" in p:
            sd[key + "downsample.0.weight"] = _conv(p["downsample_conv"]["kernel"])
            bn(p["downsample_bn"], s["downsample_bn"], key + "downsample.1")
    sd[prefix + "fc.weight"] = _conv(params["fc"]["kernel"])
    sd[prefix + "fc.bias"] = _t(params["fc"]["bias"])


NPZ_SEP = "/"   # joins the path of a leaf in the .npz keys


def load_npz_variables(path) -> dict:
    """The nested {"params", "batch_stats"} numpy tree stored in ``path``, a
    ``.npz`` whose keys are the leaves' paths joined by NPZ_SEP (as
    ``scripts/export_release_npz.py`` writes it). Raises if the file does not
    load or holds no params."""
    tree: dict = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split(NPZ_SEP)
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = z[key]
    if "params" not in tree:
        raise ValueError(f"{path} holds no params tree (keys: {sorted(tree)[:5]})")
    return tree


def from_jax_segnet_variables(variables) -> dict:
    """{"params": {"fcn"[, "fcn_depth"]}, "batch_stats"} numpy tree of the JAX
    SEGNET -> state_dict of the port's ``SEGNET`` (``fcn.resnet34_8s.*`` and,
    with two towers, ``fcn_depth.resnet34_8s.*``). A grouped tree (the JAX
    package's ``fuse_grouped_towers``) has one tower of twice the width."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    for tower in ("fcn", "fcn_depth"):
        if tower in params:
            _backbone(params[tower], stats[tower], f"{tower}.resnet34_8s.", sd)
    return sd


def fuse_tower_state(state_dict) -> dict:
    """Fuse every two-tower pair ``<p>fcn.*`` / ``<p>fcn_depth.*`` of a
    state_dict into the grouped single stack of ``SEGNET(grouped_towers=
    True)`` (the counterpart of the JAX package's ``fuse_tower_params``):
    a grouped conv's weight [out_total, in / groups, kh, kw] holds the groups
    along its output axis, so stacking the towers' weights (and every per-
    channel BatchNorm and bias leaf) on axis 0 gives the two towers exactly.
    Checkpoints keep the two-tower layout; this runs at load time."""
    fused = {}
    for key, value in state_dict.items():
        m = re.fullmatch(r"((?:.*\.)?)fcn_depth\.(.*)", key)
        if m and f"{m.group(1)}fcn.{m.group(2)}" in state_dict:
            continue                                   # joined into its fcn twin
        m = re.fullmatch(r"((?:.*\.)?)fcn\.(.*)", key)
        twin = m and state_dict.get(f"{m.group(1)}fcn_depth.{m.group(2)}")
        if twin is not None and value.dim() > 0:
            value = torch.cat([value, twin], 0)
        fused[key] = value
    return fused


_REFERENCE_KEYS = re.compile(
    r"((pretrained_backbone\.)?(fcn|fcn_depth)\.resnet34_8s\.(conv1|bn1|fc|layer\d+)\..*"
    r"|sem_seg_head\.pixel_decoder\.mask_features\.(weight|bias)"
    r"|backbone\.(stem|res[2-5])\..*"
    r"|backbone\.(patch_embed|norm\d|layers\.\d+\.(downsample|blocks\.\d+\.(norm[12]|mlp"
    r"|attn\.(qkv|proj|relative_position_bias_table))))(\..*)?"
    r"|sem_seg_head\.pixel_decoder\.(input_proj|transformer|adapter_\d+|layer_\d+)\..*"
    r"|sem_seg_head\.predictor\.(query_feat|query_embed|level_embed|static_query|input_proj"
    r"|transformer_(cross|self)_attention_layers|transformer_ffn_layers|decoder_norm"
    r"|class_embed|mask_embed)\..*)")


def load_reference_checkpoint(path) -> dict:
    """A reference ``.pth`` (a UCN SEGNET, a PretrainedMeanShiftMaskFormer or
    a standard-backbone MeanShiftMaskFormer checkpoint: detectron2 ResNet50
    or Swin, MSDeformAttn pixel decoder, 3-level decoder) as a state_dict
    that the port's ``SEGNET``, ``MSMFormer`` or ``StandardMaskFormer``
    loads with ``strict=True``. Read with ``torch.load(weights_only=True)``;
    detectron2's ``{"model": ...}`` wrapper is unwrapped, as the JAX
    package's ``load_torch_state_dict`` does. The legacy key rewrites and the
    keys left out are those of its ``convert_ucn_checkpoint`` and
    ``convert_msmformer_checkpoint``: the ``module.`` and ``model.``
    prefixes are dropped, ``static_query`` becomes ``query_feat``, and keys
    that hold no weight of the network (criterion and embedding-loss
    buffers, pixel statistics, SEGNET decoder keys, Swin's
    ``relative_position_index``) are left out."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(data, dict) and isinstance(data.get("model"), dict):
        data = data["model"]                       # detectron2 checkpointer format
    sd = {}
    for key, value in data.items():
        for prefix in ("module.", "model."):
            if key.startswith(prefix):
                key = key[len(prefix):]
        if not _REFERENCE_KEYS.fullmatch(key):
            continue
        sd[key.replace("predictor.static_query.", "predictor.query_feat.")] = value
    if not sd:
        raise ValueError(f"{path} holds no SEGNET, MSMFormer or MeanShiftMaskFormer weights")
    return sd


def from_jax_variables(variables) -> dict:
    """{"params", "batch_stats"} numpy tree of the JAX MSMFormer or
    StandardMaskFormer -> state_dict of the port's model of that arch."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd = {}
    if "backbone" in params:                 # StandardMaskFormer
        bb = params["backbone"]
        if "patch_embed" in bb:
            _swin_backbone(bb, sd)
        else:
            _d2_resnet(bb, stats["backbone"], sd)
        _pixel_decoder(params["pixel_decoder"], sd)
    else:
        bb, bbs = params["pretrained_backbone"], stats["pretrained_backbone"]
        for tower in ("fcn", "fcn_depth"):      # one tower or two
            if tower in bb:
                _backbone(bb[tower], bbs[tower], f"pretrained_backbone.{tower}.resnet34_8s.", sd)
        pd = params["pixel_decoder"]
        if "mask_features" in pd:
            sd["sem_seg_head.pixel_decoder.mask_features.weight"] = _conv(
                pd["mask_features"]["kernel"])
            sd["sem_seg_head.pixel_decoder.mask_features.bias"] = _t(pd["mask_features"]["bias"])
    _predictor(params["predictor"], sd)
    return sd


def _norm(p, key, sd):
    sd[key + ".weight"], sd[key + ".bias"] = _t(p["scale"]), _t(p["bias"])


def _linear(p, key, sd):
    sd[key + ".weight"] = _dense(p["kernel"])
    if "bias" in p:
        sd[key + ".bias"] = _t(p["bias"])


def _conv_leaf(p, key, sd):
    sd[key + ".weight"] = _conv(p["kernel"])
    if "bias" in p:
        sd[key + ".bias"] = _t(p["bias"])


def _d2_resnet(params, stats, sd):
    """JAX ResNetBackbone tree -> detectron2 keys (``backbone.stem.conv1``,
    ``backbone.res{s}.{b}.conv{i}`` / ``.shortcut``, each with ``.norm``)."""
    def conv_bn(p, s, conv, bn, key):
        sd[key + ".weight"] = _conv(p[conv]["kernel"])
        _norm(p[bn], key + ".norm", sd)
        sd[key + ".norm.running_mean"] = _t(s[bn]["mean"])
        sd[key + ".norm.running_var"] = _t(s[bn]["var"])

    conv_bn(params, stats, "stem_conv1", "stem_bn1", "backbone.stem.conv1")
    for name, p in params.items():
        m = re.fullmatch(r"res(\d)_(\d+)", name)
        if not m:
            continue
        key = f"backbone.res{m.group(1)}.{m.group(2)}."
        for i in (1, 2, 3):
            conv_bn(p, stats[name], f"conv{i}", f"bn{i}", f"{key}conv{i}")
        if "downsample_conv" in p:
            conv_bn(p, stats[name], "downsample_conv", "downsample_bn", key + "shortcut")


# the JAX PatchMerging concatenates the 2x2 neighbours as (row, col) =
# (0,0), (0,1), (1,0), (1,1); the reference (and the port) as (0,0), (1,0),
# (0,1), (1,1): quarters 1 and 2 swap
_MERGE_ORDER = (0, 2, 1, 3)


def _merge_perm(n4: int):
    q = n4 // 4
    return np.concatenate([np.arange(q) + q * j for j in _MERGE_ORDER])


def _swin_backbone(params, sd):
    """JAX SwinTransformer tree -> reference D2SwinTransformer keys, with the
    merged channels of each PatchMerging reordered from the JAX package's
    concatenation to the reference's (the same function at whole-window
    sizes)."""
    B = "backbone."
    _conv_leaf(params["patch_embed"], B + "patch_embed.proj", sd)
    _norm(params["patch_norm"], B + "patch_embed.norm", sd)
    for name, p in params.items():
        m = re.fullmatch(r"stage(\d+)_block(\d+)|merge(\d+)|out_norm(\d+)", name)
        if not m:
            continue
        st, blk, mg, on = m.groups()
        if blk is not None:
            key = f"{B}layers.{st}.blocks.{blk}."
            _norm(p["norm1"], key + "norm1", sd)
            _norm(p["norm2"], key + "norm2", sd)
            _linear(p["attn"]["qkv"], key + "attn.qkv", sd)
            _linear(p["attn"]["proj"], key + "attn.proj", sd)
            sd[key + "attn.relative_position_bias_table"] = _t(
                p["attn"]["relative_position_bias_table"])
            _linear(p["mlp_fc1"], key + "mlp.fc1", sd)
            _linear(p["mlp_fc2"], key + "mlp.fc2", sd)
        elif mg is not None:
            key = f"{B}layers.{mg}.downsample."
            inv = np.argsort(_merge_perm(np.asarray(p["norm"]["scale"]).shape[0]))
            sd[key + "norm.weight"] = _t(np.asarray(p["norm"]["scale"])[inv])
            sd[key + "norm.bias"] = _t(np.asarray(p["norm"]["bias"])[inv])
            sd[key + "reduction.weight"] = _t(np.asarray(p["reduction"]["kernel"])[inv].T)
        else:
            _norm(p, f"{B}norm{on}", sd)


def _pixel_decoder(pd, sd):
    """JAX pixel-decoder tree (MSDeformAttn, FPN or transformer-encoder) ->
    the reference's keys. The JAX MSDeformAttn decoder adds level_embed[L-1-l]
    to level l (res5 first); the reference (and the port) adds level_embed[l],
    so the rows are reversed (the same function)."""
    P = "sem_seg_head.pixel_decoder."
    n_fpn = sum(1 for k in pd if k.startswith("output_conv_"))   # FPN levels
    for name, p in pd.items():
        m = re.fullmatch(r"(input_proj|input_norm|encoder_layer|adapter|adapter_norm|layer"
                         r"|layer_norm|output_conv|output_norm|lateral_conv|lateral_norm)_(\d+)",
                         name)
        if name == "level_embed":
            sd[P + "transformer.level_embed"] = _t(np.asarray(p)[::-1])
        elif name == "mask_features":
            _conv_leaf(p, P + "mask_features", sd)
        elif name == "input_proj":                    # transformer-encoder decoder
            _conv_leaf(p, P + "input_proj", sd)
        elif m is None:
            continue
        else:
            kind, i = m.group(1), int(m.group(2))
            if kind == "input_proj":
                _conv_leaf(p, f"{P}input_proj.{i}.0", sd)
            elif kind == "input_norm":
                _norm(p, f"{P}input_proj.{i}.1", sd)
            elif kind == "encoder_layer":
                key = f"{P}transformer.encoder.layers.{i}."
                for sub in ("norm1", "norm2"):
                    _norm(p[sub], key + sub, sd)
                for sub in ("linear1", "linear2"):
                    _linear(p[sub], key + sub, sd)
                a = p["self_attn"]
                if "q_kernel" in a:                  # softmax attention
                    _mha(a, key + "self_attn.", sd)
                else:
                    for sub in ("sampling_offsets", "attention_weights", "value_proj",
                                "output_proj"):
                        _linear(a[sub], f"{key}self_attn.{sub}", sd)
            elif kind in ("adapter", "layer"):       # MSDeformAttn extra FPN level
                sd[f"{P}{kind}_{i + 1}.weight"] = _conv(p["kernel"])
            elif kind in ("adapter_norm", "layer_norm"):
                _norm(p, f"{P}{kind[:-5]}_{i + 1}.norm", sd)
            else:                                     # FPN: index 0 = res5 = layer_{n}
                n = n_fpn - i
                mod = {"output": "layer", "lateral": "adapter"}[kind.split("_")[0]]
                if kind.endswith("conv"):
                    sd[f"{P}{mod}_{n}.weight"] = _conv(p["kernel"])
                else:
                    _norm(p, f"{P}{mod}_{n}.norm", sd)


def _mha(leaf, mod, sd):
    sd[mod + "in_proj_weight"] = torch.cat([_dense(leaf[f"{x}_kernel"]) for x in "qkv"], 0)
    sd[mod + "in_proj_bias"] = torch.cat([_t(leaf[f"{x}_bias"]) for x in "qkv"], 0)
    sd[mod + "out_proj.weight"] = _dense(leaf["out_kernel"])
    sd[mod + "out_proj.bias"] = _t(leaf["out_bias"])


def _predictor(pr, sd):
    """JAX MeanShiftDecoder tree -> ``sem_seg_head.predictor.*``."""
    P = "sem_seg_head.predictor."
    for name in ("query_feat", "query_embed", "level_embed"):
        sd[P + name + ".weight"] = _t(pr[name])
    for name, leaf in pr.items():
        m = re.fullmatch(r"(cross|self)_(attn|norm)_(\d+)|ffn_(lin1|lin2|norm)_(\d+)|input_proj_(\d+)", name)
        if m is None:
            continue
        kind, what, i, ffn, j, l = m.groups()
        if l is not None:
            _conv_leaf(leaf, f"{P}input_proj.{l}", sd)
        elif ffn is not None:
            key = f"{P}transformer_ffn_layers.{j}."
            if ffn == "norm":
                _norm(leaf, key + "norm", sd)
            else:
                _linear(leaf, key + ("linear1" if ffn == "lin1" else "linear2"), sd)
        else:
            key = f"{P}transformer_{kind}_attention_layers.{i}."
            if what == "norm":
                _norm(leaf, key + "norm", sd)
            else:
                _mha(leaf, key + ("meanshift_attn." if kind == "cross" else "self_attn."), sd)
    _norm(pr["decoder_norm"], P + "decoder_norm", sd)
    _linear(pr["class_embed"], P + "class_embed", sd)
    for name, leaf in pr["mask_embed"].items():
        _linear(leaf, f"{P}mask_embed.layers.{name.split('_')[1]}", sd)


def _np(t):
    return t.detach().cpu().numpy()


def _conv_back(t):
    return np.transpose(_np(t), (2, 3, 1, 0))


def to_jax_variables(state_dict) -> dict:
    """The inverse of from_jax_variables, for either arch: a state_dict of
    the port's model (reference key names) -> the JAX package's
    {"params", "batch_stats"} numpy tree. Also takes a dict of gradients
    under the parameters' names (no buffers): its tree then has no
    batch_stats (and, for the ResNet50, no BatchNorm leaf: the port's
    BatchNorm is frozen). The ResNet50's frozen BatchNorm buffers become
    scale and bias in params and mean and var in batch_stats; Swin's merged
    channels go back to the JAX concatenation order; the MSDeformAttn pixel
    decoder's level_embed rows are reversed back. The CPU tests read the
    port's updated parameters, gradients and running statistics back in the
    JAX layout with it."""
    params: dict = {}
    stats: dict = {}

    def put(tree, path, value):
        for name in path[:-1]:
            tree = tree.setdefault(name, {})
        tree[path[-1]] = value

    pd_keys = [k[len(_PD):] for k in state_dict if k.startswith(_PD)]
    for key, t in state_dict.items():
        parts = key.split(".")
        if parts[0] == "backbone":
            _standard_backbone_back(parts[1:], t, lambda path, v: put(params, path, v),
                                    lambda path, v: put(stats, path, v))
        elif key.startswith(_PD) and not key.startswith(_PD + "mask_features."):
            _pixel_decoder_back(key[len(_PD):].split("."), t, pd_keys,
                                lambda path, v: put(params, ["pixel_decoder"] + path, v))
        elif parts[0] == "pretrained_backbone":
            tower = parts[1]
            rest = parts[3:]                             # after <tower>.resnet34_8s
            if rest[0].startswith("layer"):
                mod = [f"{rest[0]}_{rest[1]}"]
                leaf = rest[2:]
                if leaf[0] == "downsample":
                    leaf = ["downsample_conv" if leaf[1] == "0" else "downsample_bn"] + leaf[2:]
            else:
                mod, leaf = [], rest
            path = ["pretrained_backbone", tower] + mod + [leaf[0]]
            what = leaf[-1]
            if what in ("running_mean", "running_var"):
                put(stats, path + ["mean" if what == "running_mean" else "var"], _np(t))
            elif what == "weight" and t.dim() == 4:
                put(params, path + ["kernel"], _conv_back(t))
            elif what == "weight":
                put(params, path + ["scale"], _np(t))
            elif what == "bias":
                put(params, path + ["bias"], _np(t))
        elif key.startswith("sem_seg_head.pixel_decoder.mask_features."):
            put(params, ["pixel_decoder", "mask_features",
                         "kernel" if parts[-1] == "weight" else "bias"],
                _conv_back(t) if parts[-1] == "weight" else _np(t))
        elif key.startswith("sem_seg_head.predictor."):
            _predictor_back(parts[2:], t, lambda path, v: put(params, ["predictor"] + path, v))
    return {"params": params, "batch_stats": stats} if stats else {"params": params}


_PD = "sem_seg_head.pixel_decoder."


def _put_leaf(put, path, t, what, kind="dense"):
    """A torch weight or bias of a conv (JAX kernel [kh, kw, in, out]), a
    dense layer ([in, out]) or a norm (scale) under path."""
    if what == "bias":
        put(path + ["bias"], _np(t))
    elif kind == "norm":
        put(path + ["scale"], _np(t))
    else:
        put(path + ["kernel"], _conv_back(t) if kind == "conv" else _np(t).T)


def _mha_back(put, path, t, sub, what):
    """An ``in_proj_weight`` / ``in_proj_bias`` / ``out_proj.*`` leaf into
    the JAX attention's q/k/v and out leaves under path (the inverse of
    ``_mha``)."""
    if sub == "out_proj":
        put(path + ["out_kernel" if what == "weight" else "out_bias"],
            _np(t).T if what == "weight" else _np(t))
        return
    for x, chunk in zip("qkv", t.chunk(3)):
        if what == "in_proj_weight":
            put(path + [f"{x}_kernel"], _np(chunk).T)
        else:
            put(path + [f"{x}_bias"], _np(chunk))


def _standard_backbone_back(parts, t, put, put_stat):
    """One ``backbone.*`` leaf (detectron2 ResNet50 or Swin) into the JAX
    ``backbone`` tree."""
    what, B = parts[-1], ["backbone"]
    if parts[0] in ("stem", "res2", "res3", "res4", "res5"):     # ResNet50
        if parts[0] == "stem":
            mod, (conv, *rest) = [], parts[1:]
            names = {"conv1": ("stem_conv1", "stem_bn1")}
        else:
            mod, (conv, *rest) = [f"{parts[0]}_{parts[1]}"], parts[2:]
            names = {c: (c, f"bn{c[-1]}") for c in ("conv1", "conv2", "conv3")}
            names["shortcut"] = ("downsample_conv", "downsample_bn")
        conv_name, bn_name = names[conv]
        if rest == ["weight"]:
            put(B + mod + [conv_name, "kernel"], _conv_back(t))
        elif what in ("running_mean", "running_var"):      # the frozen BatchNorm's buffers
            put_stat(B + mod + [bn_name, "mean" if what == "running_mean" else "var"], _np(t))
        else:
            _put_leaf(put, B + mod + [bn_name], t, what, "norm")
    elif parts[0] == "patch_embed":
        if parts[1] == "proj":
            _put_leaf(put, B + ["patch_embed"], t, what, "conv")
        else:
            _put_leaf(put, B + ["patch_norm"], t, what, "norm")
    elif parts[0].startswith("norm"):
        _put_leaf(put, B + [f"out_norm{parts[0][4:]}"], t, what, "norm")
    elif parts[2] == "downsample":                            # layers.{s}.downsample
        merge = B + [f"merge{parts[1]}"]
        if parts[3] == "norm":
            put(merge + ["norm", "scale" if what == "weight" else "bias"],
                _np(t)[_merge_perm(t.shape[0])])
        else:
            put(merge + ["reduction", "kernel"], _np(t).T[_merge_perm(t.shape[1])])
    else:                                                     # layers.{s}.blocks.{b}
        block, sub = B + [f"stage{parts[1]}_block{parts[3]}"], parts[4]
        if sub in ("norm1", "norm2"):
            _put_leaf(put, block + [sub], t, what, "norm")
        elif sub == "mlp":
            _put_leaf(put, block + [f"mlp_{parts[5]}"], t, what)
        elif parts[5] == "relative_position_bias_table":
            put(block + ["attn", "relative_position_bias_table"], _np(t))
        else:                                                 # attn.qkv / attn.proj
            _put_leaf(put, block + ["attn", parts[5]], t, what)


def _pixel_decoder_back(parts, t, pd_keys, put):
    """One ``sem_seg_head.pixel_decoder.*`` leaf of a standard arch (the
    MSDeformAttn, FPN or transformer-encoder decoder; ``mask_features``
    aside, which every pixel decoder names alike) into the JAX
    ``pixel_decoder`` tree: the inverse of ``_pixel_decoder``. pd_keys: every
    key of the pixel decoder, which tell the decoders apart."""
    what, head = parts[-1], parts[0]
    if head == "input_proj" and len(parts) == 2:             # transformer-encoder decoder
        _put_leaf(put, [head], t, what, "conv")
    elif head == "input_proj":                                # input_proj.{i}.{0 conv, 1 GN}
        if parts[2] == "0":
            _put_leaf(put, [f"input_proj_{parts[1]}"], t, what, "conv")
        else:
            _put_leaf(put, [f"input_norm_{parts[1]}"], t, what, "norm")
    elif head == "transformer" and parts[1] == "level_embed":
        put(["level_embed"], _np(t)[::-1].copy())
    elif head == "transformer":                               # encoder.layers.{i}.*
        layer, sub = [f"encoder_layer_{parts[3]}"], parts[4]
        if sub in ("norm1", "norm2"):
            _put_leaf(put, layer + [sub], t, what, "norm")
        elif sub in ("linear1", "linear2"):
            _put_leaf(put, layer + [sub], t, what)
        elif parts[5] in ("sampling_offsets", "attention_weights", "value_proj",
                          "output_proj"):                     # MSDeformAttn
            _put_leaf(put, layer + ["self_attn", parts[5]], t, what)
        else:                                                 # softmax attention
            _mha_back(put, layer + ["self_attn"], t, parts[5], what)
    else:                                                     # adapter_{n} / layer_{n}
        kind, n = head.split("_")
        norm = parts[1] == "norm"
        if any(k == "transformer.level_embed" for k in pd_keys):
            # MSDeformAttn: the extra FPN level, numbered from 0
            name = f"{kind}_norm_{int(n) - 1}" if norm else f"{kind}_{int(n) - 1}"
        else:                                                 # FPN: index 0 = res5 = layer_{n}
            n_fpn = len({k.split(".")[0] for k in pd_keys if k.startswith("layer_")})
            base = {"layer": "output", "adapter": "lateral"}[kind]
            name = f"{base}_{'norm' if norm else 'conv'}_{n_fpn - int(n)}"
        if norm:
            _put_leaf(put, [name], t, what, "norm")
        else:
            put([name, "kernel"], _conv_back(t))


def _predictor_back(parts, t, put):
    """One ``sem_seg_head.predictor.*`` leaf into the JAX decoder tree."""
    name, what = parts[0], parts[-1]
    if name in ("query_feat", "query_embed", "level_embed"):
        put([name], _np(t))
    elif name == "input_proj":
        put([f"input_proj_{parts[1]}", "kernel" if what == "weight" else "bias"],
            _conv_back(t) if what == "weight" else _np(t))
    elif name in ("decoder_norm", "class_embed"):
        kind = "scale" if name == "decoder_norm" and what == "weight" else (
            "kernel" if what == "weight" else "bias")
        put([name, kind], _np(t).T if kind == "kernel" else _np(t))
    elif name == "mask_embed":
        put(["mask_embed", f"layers_{parts[2]}", "kernel" if what == "weight" else "bias"],
            _np(t).T if what == "weight" else _np(t))
    elif name == "transformer_ffn_layers":
        i, sub = parts[1], parts[2]
        if sub == "norm":
            put([f"ffn_norm_{i}", "scale" if what == "weight" else "bias"], _np(t))
        else:
            put([f"ffn_{'lin1' if sub == 'linear1' else 'lin2'}_{i}",
                 "kernel" if what == "weight" else "bias"],
                _np(t).T if what == "weight" else _np(t))
    else:                                                # cross / self attention layers
        kind = "cross" if "cross" in name else "self"
        i, sub = parts[1], parts[2]
        if sub == "norm":
            put([f"{kind}_norm_{i}", "scale" if what == "weight" else "bias"], _np(t))
        else:
            _mha_back(put, [f"{kind}_attn_{i}"], t, parts[3], what)


@torch.no_grad()
def init_random(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights with the JAX package's initializers: convs
    lecun-normal, linear and attention kernels xavier-uniform (q/k/v each on
    its own [E, E] block; Swin's linear kernels and bias tables truncated
    normal 0.02), embeddings and level embeddings standard normal, biases
    zero, norms identity, BatchNorm statistics mean 0 / variance 1, the
    deformable attention's offset and weight kernels zero with the
    reference's offset bias. Sets every parameter and buffer, so the model
    may come from ``to_empty``."""
    from .models.backbone_resnet import FrozenBatchNorm2d
    from .models.decoder import MeanShiftAttention
    from .models.pixel_decoders import SoftmaxAttention, _EncoderOnly
    from .models.swin import SwinTransformer, WindowAttention
    from .ops.ms_deform_attn import MSDeformAttn

    swin = {id(sub) for m in model.modules() if isinstance(m, SwinTransformer)
            for sub in m.modules()}
    for m in model.modules():
        if id(m) in swin and isinstance(m, (nn.Linear, WindowAttention)):
            _trunc_normal(m.weight if isinstance(m, nn.Linear)
                          else m.relative_position_bias_table, generator)
            if isinstance(m, nn.Linear) and m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            nn.init.xavier_uniform_(m.weight, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d, nn.GroupNorm, FrozenBatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, (nn.BatchNorm2d, FrozenBatchNorm2d)):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            if isinstance(m, nn.BatchNorm2d):
                m.num_batches_tracked.zero_()
        elif isinstance(m, (MeanShiftAttention, SoftmaxAttention)):
            for w in m.in_proj_weight.chunk(3):
                nn.init.xavier_uniform_(w, generator=generator)
            m.in_proj_bias.zero_()
        elif isinstance(m, _EncoderOnly):
            m.level_embed.normal_(0.0, 1.0, generator=generator)
    for m in model.modules():      # the deformable attention's init over the defaults
        if isinstance(m, MSDeformAttn):
            m.sampling_offsets.weight.zero_()
            m.sampling_offsets.bias.copy_(_offset_bias(m.n_heads, m.n_levels, m.n_points))
            m.attention_weights.weight.zero_()
    return model


def _trunc_normal(t, generator, std=0.02):
    """flax's truncated_normal(std): a normal truncated at two of its
    standard deviations, scaled so that the truncated one has std."""
    s = std / 0.87962566
    nn.init.trunc_normal_(t, 0.0, s, -2.0 * s, 2.0 * s, generator=generator)


def _offset_bias(n_heads: int, n_levels: int, n_points: int):
    """The reference's sampling-offset bias: per-head unit directions at
    angles 2 pi h / H, scaled by the point index (JAX ms_deform_attn.py
    _offset_bias_init; ref: ms_deform_attn.py _reset_parameters)."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * np.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    grid *= np.arange(1, n_points + 1, dtype=np.float32)[None, None, :, None]
    return torch.from_numpy(grid.reshape(-1).astype(np.float32))
