"""UCN embedding network (SEGNET): RGB / XYZ / fused RGB-D towers ->
L2-normalized per-pixel embeddings.

Port of ``unseenobjectswithmeanshift_tpu.models.segnet`` (ref:
lib/networks/SEG.py:26-126). Inputs (SEG.py:97-110):
- COLOR: the RGB tower alone (``fcn``);
- DEPTH: one tower on the XYZ map (``fcn``);
- RGBD 'early': one tower on the 6-channel RGB | XYZ input (``fcn``);
- RGBD 'add': RGB and XYZ towers (``fcn``, ``fcn_depth``), features summed
  (the shipped RGB-D checkpoints);
- RGBD 'cat': the same two towers, features concatenated (2 * num_units
  channels).
``grouped_towers`` runs the two RGB-D towers as one grouped conv stack
(``groups=2``) on the channel-stacked input: the same function, each conv
twice as wide. Checkpoints keep the two-tower layout; ``weights.
fuse_tower_state`` fuses them at load time. Each tower sits under the
checkpoint prefix ``<tower>.resnet34_8s``. Public layout is NHWC like the JAX
package; the towers run NCHW.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .resnet import resnet34_8s

INPUT_TYPES = ("COLOR", "DEPTH", "RGBD")
FUSION_TYPES = ("early", "add", "cat")


def l2_normalize(x, dim=-1, eps=1e-12):
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


class _Tower(nn.Module):
    """Holds the FCN under the reference's ``<tower>.resnet34_8s`` key."""

    def __init__(self, num_units: int, in_channels: int = 3, groups: int = 1):
        super().__init__()
        self.resnet34_8s = resnet34_8s(num_units, in_channels, groups)

    def forward(self, x):
        return self.resnet34_8s(x)


class SEGNET(nn.Module):
    """SEGNET of any input type and fusion (ResNet34-8s towers)."""

    def __init__(self, num_units: int = 64, input_type: str = "RGBD", fusion_type: str = "add",
                 normalize: bool = True, grouped_towers: bool = False,
                 network: str = "resnet34_8s"):
        super().__init__()
        if network != "resnet34_8s":
            raise ValueError(f"backbone.network {network!r} is not ported: resnet50_8s, unet "
                             "and vgg belong to ROADMAP queue 1 item 10 (the standard-backbone "
                             "family)")
        if input_type not in INPUT_TYPES or fusion_type not in FUSION_TYPES:
            raise ValueError(f"input_type must be one of {INPUT_TYPES} and fusion_type one of "
                             f"{FUSION_TYPES}, got {input_type!r}, {fusion_type!r}")
        self.num_units, self.input_type, self.fusion_type = num_units, input_type, fusion_type
        self.normalize = normalize
        self.early = input_type == "RGBD" and fusion_type == "early"
        two_tower = input_type == "RGBD" and not self.early
        self.grouped = two_tower and grouped_towers
        self.fcn = _Tower(num_units, 6 if self.early else 3, 2 if self.grouped else 1)
        if two_tower and not self.grouped:
            self.fcn_depth = _Tower(num_units)
        self.out_channels = 2 * num_units if two_tower and fusion_type == "cat" else num_units

    def raw_nchw(self, img, xyz):
        """The fused features before the L2 normalization: img, xyz
        [B, 3, H, W] (either may be None where the input type reads none) ->
        [B, out_channels, H, W]."""
        if self.input_type == "COLOR":
            return self.fcn(img)
        if self.input_type == "DEPTH":
            return self.fcn(xyz)
        if self.early:
            return self.fcn(torch.cat([img, xyz], 1))
        U = self.num_units
        if self.grouped:
            both = self.fcn(torch.cat([img, xyz], 1))
            return both[:, :U] + both[:, U:] if self.fusion_type == "add" else both
        f, fd = self.fcn(img), self.fcn_depth(xyz)
        return f + fd if self.fusion_type == "add" else torch.cat([f, fd], 1)

    def forward_nchw(self, img, xyz=None):
        """img, xyz: [B, 3, H, W] -> [B, out_channels, H, W]."""
        features = self.raw_nchw(img, xyz)
        return l2_normalize(features, dim=1) if self.normalize else features

    def forward(self, img, xyz=None):
        """img, xyz: [B, H, W, 3] (NHWC) -> [B, H, W, out_channels]."""
        t = lambda x: None if x is None else x.permute(0, 3, 1, 2)
        return self.forward_nchw(t(img), t(xyz)).permute(0, 2, 3, 1)


def build_segnet(backbone, grouped_towers: bool = True) -> SEGNET:
    """SEGNET of a ``BackboneConfig`` (ref factory: lib/networks/SEG.py:173-186).
    grouped_towers=False ignores ``backbone.grouped_towers``, as the JAX
    package's MSMFormer does."""
    b = backbone
    return SEGNET(b.num_units, b.input_type, b.fusion_type, b.normalize,
                  grouped_towers and b.grouped_towers, b.network)
