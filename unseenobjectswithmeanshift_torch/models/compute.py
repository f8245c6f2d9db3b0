"""The compute dtype of the port's networks, threaded from the configuration.

``Config.dtype`` ("float32" or "bfloat16") is the dtype every convolution and
linear layer computes in, as the JAX package's ``build_model(cfg, dtype)``
gives each flax module its ``dtype`` (JAX ``models/meta_arch.py:262-271``).
Parameters stay fp32: ``state_dict()`` keys and dtypes are those of the fp32
model, so the weight loaders need no bf16 branch. Each ``Conv2d`` and
``Linear`` here casts its weight and bias to the compute dtype at use (one
cast a call; an fp32 tensor's ``.to(torch.float32)`` is the tensor itself,
so the fp32 path is unchanged). In bf16 PyTorch runs cuDNN and cuBLAS with
bf16 operands and fp32 accumulation, as the JAX package's DEFAULT precision
does for bf16 (JAX ``models/resnet.py:34-38``); fp32 keeps TF32 off, which
the entry points set. BatchNorm takes the compute dtype in and out with
its fp32 parameters (PyTorch normalizes in fp32 inside); ``LayerNorm``
here normalizes in fp32 and casts its output back, as flax does.
``torch.autocast`` is not used: its per-op cast lists are not the JAX
package's, and they hide where the rounding happens. In training the casts
are autograd ops: a bf16 step (either arch) computes the gradients in the
compute dtype and hands each fp32 parameter an fp32 gradient, as the JAX
package's fp32 parameters get theirs.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.hypersphere_attention import at_least_fp32

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``Config.dtype`` string; raises on any other."""
    if name not in DTYPES:
        raise ValueError(f"dtype must be one of {tuple(DTYPES)}, got {name!r}")
    return DTYPES[name]


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in ``compute_dtype`` (input, weight and bias cast
    at use; fp32 parameters)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Linear(nn.Linear):
    """nn.Linear computing in ``compute_dtype`` (input, weight and bias cast
    at use; fp32 parameters)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm of the input's dtype, computed in at least fp32 (fp32
    parameters) and cast back to the input's dtype."""

    def forward(self, x):
        y = F.layer_norm(x.to(at_least_fp32(x.dtype)), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose training mode is flax's ``BatchNorm(momentum=0.9)``
    (the JAX package's, ``models/resnet.py:52``): normalize with the batch
    mean and the *biased* variance E[x^2] - E[x]^2 (clamped at 0), computed in
    at least fp32, and blend that biased variance into the running variance:
    running = 0.9 running + 0.1 batch. (torch's own training mode blends the
    unbiased variance.) Eval mode is torch's, on the running statistics.
    The output has the input's dtype."""

    FLAX_MOMENTUM = 0.9

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        xf = x.to(at_least_fp32(x.dtype))
        mean = xf.mean((0, 2, 3))
        var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = self.FLAX_MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm of the input's dtype, computed in at least fp32 (fp32
    parameters) and cast back to the input's dtype."""

    def forward(self, x):
        y = F.group_norm(x.to(at_least_fp32(x.dtype)), self.num_groups, self.weight,
                         self.bias, self.eps)
        return y.to(x.dtype)
