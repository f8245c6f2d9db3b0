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
    r"|sem_seg_head\.predictor\.(query_feat|query_embed|level_embed|static_query|input_proj"
    r"|transformer_(cross|self)_attention_layers|transformer_ffn_layers|decoder_norm"
    r"|class_embed|mask_embed)\..*)")


def load_reference_checkpoint(path) -> dict:
    """A reference ``.pth`` (a UCN SEGNET or a PretrainedMeanShiftMaskFormer
    checkpoint) as a state_dict that the port's ``SEGNET`` or ``MSMFormer``
    loads with ``strict=True``. Read with ``torch.load(weights_only=True)``;
    detectron2's ``{"model": ...}`` wrapper is unwrapped, as the JAX
    package's ``load_torch_state_dict`` does. The legacy key rewrites and the
    keys left out are those of its ``convert_ucn_checkpoint`` and
    ``convert_msmformer_checkpoint``: the ``module.`` and ``model.``
    prefixes are dropped, ``static_query`` becomes ``query_feat``, and keys
    that hold no weight of the network (criterion and embedding-loss
    buffers, pixel statistics, SEGNET decoder keys) are left out."""
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
        raise ValueError(f"{path} holds no SEGNET or MSMFormer weights")
    return sd


def from_jax_variables(variables) -> dict:
    """{"params", "batch_stats"} numpy tree of the JAX MSMFormer -> state_dict."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd = {}
    bb, bbs = params["pretrained_backbone"], stats["pretrained_backbone"]
    for tower in ("fcn", "fcn_depth"):      # one tower or two
        if tower in bb:
            _backbone(bb[tower], bbs[tower], f"pretrained_backbone.{tower}.resnet34_8s.", sd)
    pd = params["pixel_decoder"]
    if "mask_features" in pd:
        sd["sem_seg_head.pixel_decoder.mask_features.weight"] = _conv(pd["mask_features"]["kernel"])
        sd["sem_seg_head.pixel_decoder.mask_features.bias"] = _t(pd["mask_features"]["bias"])

    P = "sem_seg_head.predictor."
    pr = params["predictor"]
    for name in ("query_feat", "query_embed", "level_embed"):
        sd[P + name + ".weight"] = _t(pr[name])
    for name, leaf in pr.items():
        m = re.fullmatch(r"(cross|self)_(attn|norm)_(\d+)|ffn_(lin1|lin2|norm)_(\d+)|input_proj_(\d+)", name)
        if m is None:
            continue
        kind, what, i, ffn, j, l = m.groups()
        if l is not None:
            sd[f"{P}input_proj.{l}.weight"] = _conv(leaf["kernel"])
            sd[f"{P}input_proj.{l}.bias"] = _t(leaf["bias"])
        elif ffn is not None:
            key = f"{P}transformer_ffn_layers.{j}."
            if ffn == "norm":
                sd[key + "norm.weight"], sd[key + "norm.bias"] = _t(leaf["scale"]), _t(leaf["bias"])
            else:
                lin = "linear1" if ffn == "lin1" else "linear2"
                sd[key + lin + ".weight"], sd[key + lin + ".bias"] = _dense(leaf["kernel"]), _t(leaf["bias"])
        else:
            key = f"{P}transformer_{kind}_attention_layers.{i}."
            if what == "norm":
                sd[key + "norm.weight"], sd[key + "norm.bias"] = _t(leaf["scale"]), _t(leaf["bias"])
            else:
                mod = key + ("meanshift_attn." if kind == "cross" else "self_attn.")
                sd[mod + "in_proj_weight"] = torch.cat(
                    [_dense(leaf[f"{x}_kernel"]) for x in "qkv"], 0)
                sd[mod + "in_proj_bias"] = torch.cat([_t(leaf[f"{x}_bias"]) for x in "qkv"], 0)
                sd[mod + "out_proj.weight"] = _dense(leaf["out_kernel"])
                sd[mod + "out_proj.bias"] = _t(leaf["out_bias"])
    for name in ("decoder_norm",):
        sd[P + name + ".weight"], sd[P + name + ".bias"] = _t(pr[name]["scale"]), _t(pr[name]["bias"])
    sd[P + "class_embed.weight"] = _dense(pr["class_embed"]["kernel"])
    sd[P + "class_embed.bias"] = _t(pr["class_embed"]["bias"])
    for name, leaf in pr["mask_embed"].items():
        j = name.split("_")[1]
        sd[f"{P}mask_embed.layers.{j}.weight"] = _dense(leaf["kernel"])
        sd[f"{P}mask_embed.layers.{j}.bias"] = _t(leaf["bias"])
    return sd


@torch.no_grad()
def init_random(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights with the JAX package's initializers: convs
    lecun-normal, linear and attention kernels xavier-uniform (q/k/v each on
    its own [E, E] block), embeddings standard normal, biases zero, norms
    identity, BatchNorm statistics mean 0 / variance 1. Sets every parameter
    and buffer, so the model may come from ``to_empty``."""
    from .models.decoder import MeanShiftAttention

    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            nn.init.xavier_uniform_(m.weight, generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
        elif isinstance(m, MeanShiftAttention):
            for w in m.in_proj_weight.chunk(3):
                nn.init.xavier_uniform_(w, generator=generator)
            m.in_proj_bias.zero_()
    return model
