"""Multi-scale deformable attention (the MSDeformAttn pixel decoder's core).

Port of ``unseenobjectswithmeanshift_tpu.ops.ms_deform_attn``
(``ms_deform_attn_core`` :48-80 and the ``MSDeformAttn`` module :161-208;
ref: ops/functions/ms_deform_attn_func.py ms_deform_attn_core_pytorch,
ops/modules/ms_deform_attn.py:34-125). For each query, n_points locations
per head and level are sampled bilinearly from that level's value map and
summed with weights softmaxed over levels x points. Sampling follows
``F.grid_sample``: grid = 2 loc - 1, align_corners=False, zero padding;
the offsets are normalized by (W_l, H_l).

The JAX package computes this in XLA, not in a Pallas kernel, so the port
computes it in plain PyTorch with ``F.grid_sample`` per level, the
reference's own formulation (its CUDA im2col kernel is a speed item of the
ROADMAP, not a TPU kernel).

Dtypes: the projections compute in the module's ``dtype``; the softmax runs
in fp32 and the weights are cast back; the sampling locations are fp32
(the normalizer is fp32, as in the JAX module :202-205).

Training differentiates it with autograd: ``grid_sample``'s backward gives
the gradients with respect to the value maps, the sampling locations and
(through the weighted sum) the attention weights, the same as the VJP of
the JAX core's four gathers and lerp (tests/test_torch_train_standard.py).
Two properties of that backward: on the card it adds into the value
gradient with atomics, so two runs need not agree bit for bit
(``chip_smoke.py`` ``train_standard_check`` prints whether they do); and
at a location exactly on an integer tap, where bilinear sampling has no
derivative, each implementation's rounding of ``loc * size - 0.5`` picks
a one-sided one. The reference's init (zero offset kernels) puts every
point of the first step there.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.compute import Linear


def ms_deform_attn_core(value, spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations, attention_weights):
    """value [B, Len_in, H, D] (levels concatenated, Len_in = sum h_l w_l);
    sampling_locations [B, Lq, H, L, P, 2] normalized (x, y); attention_weights
    [B, Lq, H, L, P]. Returns [B, Lq, H * D] in value's dtype."""
    B, _, NH, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    values = value.split([h * w for h, w in spatial_shapes], dim=1)
    grids = 2 * sampling_locations - 1
    sampled = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = values[lvl].flatten(2).transpose(1, 2).reshape(B * NH, D, h, w)
        g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)        # [B NH, Lq, P, 2]
        sampled.append(F.grid_sample(v, g.to(v.dtype), mode="bilinear",
                                     padding_mode="zeros", align_corners=False))
    aw = attention_weights.transpose(1, 2).reshape(B * NH, 1, Lq, L * P)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * aw.to(value.dtype)).sum(-1)
    return out.view(B, NH * D, Lq).transpose(1, 2).contiguous()


class MSDeformAttn(nn.Module):
    """Deformable attention (ref: ops/modules/ms_deform_attn.py:34-125);
    submodule names are the reference's (``sampling_offsets``,
    ``attention_weights``, ``value_proj``, ``output_proj``)."""

    def __init__(self, d_model: int = 256, n_levels: int = 3, n_heads: int = 8,
                 n_points: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.sampling_offsets = Linear(d_model, n_heads * n_levels * n_points * 2,
                                       compute_dtype=dtype)
        self.attention_weights = Linear(d_model, n_heads * n_levels * n_points,
                                        compute_dtype=dtype)
        self.value_proj = Linear(d_model, d_model, compute_dtype=dtype)
        self.output_proj = Linear(d_model, d_model, compute_dtype=dtype)

    def forward(self, query, reference_points, input_flatten, spatial_shapes):
        """query [B, Lq, C]; reference_points [B, Lq, L, 2] normalized (x, y);
        input_flatten [B, Len, C]; spatial_shapes: list of (h_l, w_l)."""
        B, Lq, _ = query.shape
        H, L, P = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(input_flatten)
        value = value.view(B, value.shape[1], H, -1)
        offsets = self.sampling_offsets(query).view(B, Lq, H, L, P, 2)
        weights = self.attention_weights(query).view(B, Lq, H, L * P).float()
        weights = weights.softmax(-1).to(value.dtype).view(B, Lq, H, L, P)
        normalizer = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                                  device=query.device)
        locations = (reference_points[:, :, None, :, None, :].float()
                     + offsets.float() / normalizer[None, None, None, :, None, :])
        out = ms_deform_attn_core(value, spatial_shapes, locations, weights)
        return self.output_proj(out)
