"""Hypersphere (von Mises-Fisher mean-shift) attention in plain PyTorch.

Port of ``unseenobjectswithmeanshift_tpu.ops.hypersphere_attention`` (ref:
MSMFormer/.../transformer_decoder/attention_util.py:30-82, 198-432):

    q, k <- L2-normalize per head
    attn = softmax(kappa * q k^T + mask)
    out  = L2-normalize(attn v) per head

with the packed in-projection and the out-projection of multi-head attention.
The decoder's self-attention over the 100 queries runs here; the masked
cross-attention over every pixel is ``ops.fused_cross_attention``.
Batch-first [B, L, E]; projection weights in torch layout ([out, in]).

Dtypes, as in the JAX package: everything computes in the query's dtype
(the projection weights are cast to it at use), except the norms of
``l2_normalize`` (fp32, then cast back) and the softmax, which runs in fp32
whatever the input dtype, its weights cast back before p.v (JAX
``ops/hypersphere_attention.py:65-67``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

KAPPA = 30.0

_NEG_INF = -1e30


def at_least_fp32(dtype):
    """fp32 for bf16 (or fp16), the dtype itself for fp32 and fp64."""
    return torch.promote_types(dtype, torch.float32)


def l2_normalize(x, dim=-1, eps=1e-12):
    """x / max(|x|, eps), the norm taken in at least fp32 and cast to x's dtype."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True, dtype=at_least_fp32(x.dtype))
    return x / n.clamp_min(eps).to(x.dtype)


def split_heads(x, num_heads: int):
    b, l, e = x.shape
    return x.reshape(b, l, num_heads, e // num_heads).transpose(1, 2)


def merge_heads(x):
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def hypersphere_attention_core(q, k, v, kappa: float = KAPPA,
                               mask_bias: Optional[torch.Tensor] = None):
    """q, k, v: [B, H, L, D]. mask_bias: additive bias broadcastable to
    [B, H, Lq, Lk]. Returns (normalized output, attention weights)."""
    logits = kappa * torch.einsum("bhqd,bhkd->bhqk", l2_normalize(q), l2_normalize(k))
    logits = logits.to(at_least_fp32(logits.dtype))
    if mask_bias is not None:
        logits = logits + mask_bias
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
    return l2_normalize(out), attn


def bool_mask_to_bias(attn_mask_bool, guard_all_masked: bool = True):
    """bool [B, Lq, Lk] (True = may NOT attend) -> additive bias [B, 1, Lq, Lk];
    rows masked everywhere are un-masked (ref:
    meanshiftformer_transformer_decoder.py:970)."""
    if guard_all_masked:
        all_masked = attn_mask_bool.all(dim=-1, keepdim=True)
        attn_mask_bool = attn_mask_bool & ~all_masked
    bias = torch.zeros(attn_mask_bool.shape, dtype=torch.float32,
                       device=attn_mask_bool.device)
    return bias.masked_fill(attn_mask_bool, _NEG_INF)[:, None]


def meanshift_attention(query, key, value, in_proj_weight, in_proj_bias,
                        out_weight, out_bias, num_heads: int,
                        kappa: float = KAPPA, mask_bias=None):
    """Full MeanShiftAttention forward. Returns (out [B, Lq, E], head-averaged
    attention weights [B, Lq, Lk])."""
    dt = query.dtype
    wq, wk, wv = in_proj_weight.to(dt).chunk(3)
    bq, bk, bv = in_proj_bias.to(dt).chunk(3)
    q = split_heads(F.linear(query, wq, bq), num_heads)
    k = split_heads(F.linear(key, wk, bk), num_heads)
    v = split_heads(F.linear(value, wv, bv), num_heads)
    out, attn = hypersphere_attention_core(q, k, v, kappa, mask_bias)
    return (F.linear(merge_heads(out), out_weight.to(dt), out_bias.to(dt)),
            attn.mean(dim=1))
