"""Dilated ResNet FCN backbones (NCHW inside, torch idiom).

Port of ``unseenobjectswithmeanshift_tpu.models.resnet`` (ref:
lib/networks/resnet.py:44-270, resnet_dilated.py Resnet34_8s). Output stride 8
is reached by dilation: once the running stride equals the target, a stage's
stride 2 becomes dilation x2 (``_plan_stages``). A 1x1 ``fc`` conv projects to
the embedding width and a bilinear (align_corners=True) upsample restores the
input size. BatchNorm runs on its running statistics (eval mode, eps 1e-5).

Submodule names follow the reference checkpoint keys
(``conv1``, ``bn1``, ``layer{1-4}.{b}.{conv1,bn1,conv2,bn2,downsample.{0,1}}``,
``fc``). ``groups=2`` stacks two towers along the channel axis (the JAX
package's ``feature_group_count``): every conv is grouped, BatchNorm is per
channel, so each half of the channels is one tower (SEGNET.grouped_towers).
"""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F


def _plan_stages(layers: Sequence[int], block_expansion: int, output_stride: int):
    """Per-stage lists of (planes, stride, dilation, has_downsample) per block,
    with the reference's _make_layer stride/dilation bookkeeping."""
    plan = []
    current_stride = 4
    current_dilation = 1
    inplanes = 64
    for planes, nblocks, stage_stride in zip((64, 128, 256, 512), layers, (1, 2, 2, 2)):
        stride = stage_stride
        has_downsample = stride != 1 or inplanes != planes * block_expansion
        if has_downsample:
            if current_stride == output_stride:
                current_dilation *= stride
                stride = 1
            else:
                current_stride *= stride
        blocks = [(planes, stride, current_dilation, has_downsample)]
        inplanes = planes * block_expansion
        blocks += [(planes, 1, current_dilation, False)] * (nblocks - 1)
        plan.append(blocks)
    return plan


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False, groups: int = 1):
        super().__init__()
        g = groups
        self.conv1 = nn.Conv2d(inplanes * g, planes * g, 3, stride, padding=dilation,
                               dilation=dilation, bias=False, groups=g)
        self.bn1 = nn.BatchNorm2d(planes * g)
        self.conv2 = nn.Conv2d(planes * g, planes * g, 3, 1, padding=dilation,
                               dilation=dilation, bias=False, groups=g)
        self.bn2 = nn.BatchNorm2d(planes * g)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes * g, planes * g, 1, stride, bias=False, groups=g),
            nn.BatchNorm2d(planes * g)) if has_downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class DilatedResNetFCN(nn.Module):
    """ResNet-N s-FCN with basic blocks: [B, groups * in_ch, H, W] ->
    [B, groups * num_units, H, W] (in_ch per tower)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), num_units: int = 64,
                 output_stride: int = 8, in_ch: int = 3, groups: int = 1):
        super().__init__()
        g = groups
        self.conv1 = nn.Conv2d(in_ch * g, 64 * g, 7, 2, 3, bias=False, groups=g)
        self.bn1 = nn.BatchNorm2d(64 * g)
        cin = 64
        for si, blocks in enumerate(_plan_stages(layers, 1, output_stride)):
            mods = []
            for planes, stride, dilation, has_ds in blocks:
                mods.append(BasicBlock(cin, planes, stride, dilation, has_ds, g))
                cin = planes
            setattr(self, f"layer{si + 1}", nn.Sequential(*mods))
        self.fc = nn.Conv2d(cin * g, num_units * g, 1, groups=g)

    def forward(self, x):
        hw = x.shape[-2:]
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.fc(x)
        return F.interpolate(x, size=hw, mode="bilinear", align_corners=True)


def resnet34_8s(num_units: int = 64, in_channels: int = 3, groups: int = 1) -> DilatedResNetFCN:
    """ref: lib/networks/resnet_dilated.py Resnet34_8s. in_channels=6 takes
    'early' fusion's RGB | XYZ input; groups=2 stacks two towers."""
    return DilatedResNetFCN((3, 4, 6, 3), num_units, 8, in_channels, groups)
