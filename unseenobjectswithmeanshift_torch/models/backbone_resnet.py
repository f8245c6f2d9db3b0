"""detectron2-style ResNet50 with res2..res5 outputs (NCHW, cuDNN convolutions).

Port of ``unseenobjectswithmeanshift_tpu.models.backbone_resnet``
(``D2Bottleneck`` / ``ResNetBackbone`` :19-82; ref: configs/*_ResNet50.yaml,
detectron2 build_resnet_backbone): Caffe-style bottlenecks with the stride
in the 1x1 conv, frozen BatchNorm with eps 1e-5, a 7x7 stem and a 3x3 max
pool. Module names are detectron2's checkpoint keys (``stem.conv1``,
``res{2-5}.{b}.conv{1-3}``, ``res{2-5}.{b}.shortcut``, each conv with its
``.norm``), so a reference ``.pth`` loads as it is.

``dtype`` is the compute dtype (``models/compute.py``): convolutions compute
in it with fp32 weights cast at use; the frozen BatchNorm takes its input's
dtype with fp32 statistics.

In training the BatchNorm stays frozen: its four tensors are buffers (no
gradient, no running-statistics update, no optimizer entry), and only the
convolutions train, at lr x backbone_multiplier. That is detectron2's R50,
the reference's, and the layout of the published checkpoints; the JAX
module instead builds ``nn.BatchNorm(use_running_average=not train)``
(JAX :28-30, :64-65) and so trains on batch statistics (ROADMAP.md
section 3; tests/test_torch_train_standard.py pins the difference).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .compute import Conv2d


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm on fixed statistics (detectron2's FrozenBatchNorm2d: the
    buffers weight, bias, running_mean, running_var; eps 1e-5)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        for name in ("weight", "bias", "running_mean", "running_var"):
            self.register_buffer(name, torch.empty(num_features))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class ConvNorm(Conv2d):
    """detectron2's Conv2d with its attached ``norm`` (no bias, no activation)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, k, stride, padding, bias=False, compute_dtype=dtype)
        self.norm = FrozenBatchNorm2d(cout)

    def forward(self, x):
        return self.norm(super().forward(x))


class D2Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1, stride_in_1x1: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = ConvNorm(cin, planes, 1, s1, dtype=dtype)
        self.conv2 = ConvNorm(planes, planes, 3, s3, 1, dtype=dtype)
        self.conv3 = ConvNorm(planes, planes * 4, 1, dtype=dtype)
        self.shortcut = (ConvNorm(cin, planes * 4, 1, stride, dtype=dtype)
                         if stride != 1 or cin != planes * 4 else None)

    def forward(self, x):
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        return F.relu(out + (x if self.shortcut is None else self.shortcut(x)))


class _Stem(nn.Module):
    def __init__(self, dtype):
        super().__init__()
        self.conv1 = ConvNorm(3, 64, 7, 2, 3, dtype=dtype)

    def forward(self, x):
        return F.max_pool2d(F.relu(self.conv1(x)), 3, 2, 1)


class ResNetBackbone(nn.Module):
    """[B, 3, H, W] -> {"res2": [B, 256, H/4, W/4], ..., "res5": [B, 2048, H/32, W/32]}."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), stride_in_1x1: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem = _Stem(dtype)
        cin = 64
        for si, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            blocks = []
            for bi in range(n):
                stride = 2 if si > 0 and bi == 0 else 1
                blocks.append(D2Bottleneck(cin, planes, stride, stride_in_1x1, dtype))
                cin = planes * 4
            setattr(self, f"res{si + 2}", nn.Sequential(*blocks))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        outs = {}
        for name in ("res2", "res3", "res4", "res5"):
            x = getattr(self, name)(x)
            outs[name] = x
        return outs
