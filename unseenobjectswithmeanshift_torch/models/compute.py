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
package's, and they hide where the rounding happens.
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


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm of the input's dtype, computed in at least fp32 (fp32
    parameters) and cast back to the input's dtype."""

    def forward(self, x):
        y = F.group_norm(x.to(at_least_fp32(x.dtype)), self.num_groups, self.weight,
                         self.bias, self.eps)
        return y.to(x.dtype)
