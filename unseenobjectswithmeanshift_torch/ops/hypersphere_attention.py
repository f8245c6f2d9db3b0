"""Hypersphere (von Mises-Fisher mean-shift) attention in plain PyTorch.

Port of ``unseenobjectswithmeanshift_tpu.ops.hypersphere_attention`` (ref:
MSMFormer/.../transformer_decoder/attention_util.py:30-82, 198-432):

    q, k <- L2-normalize per head
    attn = softmax(kappa * q k^T + mask)
    out  = L2-normalize(attn v) per head

with the packed in-projection and the out-projection of multi-head attention.
The decoder's self-attention over the 100 queries runs here; the masked
cross-attention over every pixel is ``ops.fused_cross_attention`` in
serving. In training (the decoder's unfused path, as the JAX package trains)
the masked cross-attention runs here too: dense with ``bool_mask_to_bias``
below CHUNKED_ATTENTION_MIN_K keys, ``chunked_masked_meanshift_attention_
twopass`` from there on.
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
from torch.utils.checkpoint import checkpoint

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


LOG2E = 1.4426950408889634
CHUNK_KEYS = 8192
# the decoder's masked cross-attention switches to the chunked form at this
# key count (JAX models/decoder.py:39)
CHUNKED_ATTENTION_MIN_K = 32768
_NEG = -1e30


def _safe_normalize(x):
    """x * rsqrt(|x|^2 + 1e-24) in at least fp32, cast back: finite gradient
    at x = 0, unlike x / max(|x|, eps)."""
    xf = x.to(at_least_fp32(x.dtype))
    return (xf * torch.rsqrt(xf.square().sum(-1, keepdim=True) + 1e-24)).to(x.dtype)


def chunked_masked_meanshift_attention_twopass(query, key, value, in_proj_weight,
                                               in_proj_bias, out_weight, out_bias,
                                               num_heads: int, keep,
                                               kappa: float = KAPPA,
                                               chunk_size: int = CHUNK_KEYS):
    """Masked vMF attention for training at large K, memory O(chunk) with an
    exact gradient (JAX ``chunked_masked_meanshift_attention_twopass``,
    :231-335).

    - The all-masked-row guard is resolved up front: a row with no key
      kept attends to every key, so each row has one effective mask
      (:282-288).
    - Pass 1 finds each row's max over its effective keys, without gradient
      (softmax is shift-invariant, :298-309).
    - Pass 2 sums p = exp2(c (s - M)) v and p against that fixed max, chunk
      by chunk, each chunk under ``torch.utils.checkpoint`` so that backward
      recomputes its projections instead of holding them (:311-335). The
      denominator stays differentiable, so the gradient is exact. p keeps
      the where-form: s <= M holds bitwise on effective lanes (pass 1 runs
      the same products), and a clamp min(., 0) would split the gradient at
      the argmax lane (:319-322).

    The JAX function pads K to whole chunks with zero keys at logit -1; here
    the last chunk is shorter, which adds the same terms (a padded key
    contributes exactly 0) without copying the keys.

    query [B, Q, E]; key, value [B, K, E]; keep [B, Q, K] bool, the mask
    logits' sign (logit >= 0; the JAX function takes the logits, the
    decoder keeps this quarter of their bytes between layers). No random
    draw is made inside a chunk. Returns [B, Q, E]."""
    dt = query.dtype
    B, Q, E = query.shape
    K = key.shape[1]
    H = num_heads
    wq, wk, wv = in_proj_weight.to(dt).chunk(3)
    bq, bk, bv = in_proj_bias.to(dt).chunk(3)
    qn = l2_normalize(split_heads(F.linear(query, wq, bq), H))
    c = kappa * LOG2E
    eff = keep | ~keep.any(-1, keepdim=True)                          # the guard
    # split once: the backward of torch.split concatenates the chunks'
    # gradients in one op, where slicing key[:, s:e] chunk by chunk would
    # zero-fill and add a full [B, K, E] gradient for every chunk
    ks, vs = key.split(chunk_size, 1), value.split(chunk_size, 1)
    es = eff.split(chunk_size, 2)

    def scores(q, k_c, wk, bk):
        kh = _safe_normalize(split_heads(F.linear(k_c, wk, bk), H))
        return torch.einsum("bhqd,bhkd->bhqk", q, kh).to(at_least_fp32(dt))

    with torch.no_grad():
        M = torch.full((B, H, Q, 1), _NEG, dtype=at_least_fp32(dt), device=query.device)
        for k_c, e_c in zip(ks, es):
            sc = torch.where(e_c[:, None], scores(qn, k_c, wk, bk), _NEG)
            M = torch.maximum(M, sc.amax(-1, keepdim=True))

    def body(q, k_c, v_c, e_c, wk, bk, wv, bv):
        vh = split_heads(F.linear(v_c, wv, bv), H)
        sc = scores(q, k_c, wk, bk)
        p = torch.where(e_c[:, None], torch.exp2(c * (sc - M)), 0.0)
        num = torch.einsum("bhqk,bhkd->bhqd", p.to(dt), vh).to(at_least_fp32(dt))
        return num, p.sum(-1, keepdim=True)

    num = den = 0.0
    for k_c, v_c, e_c in zip(ks, vs, es):
        n_c, d_c = checkpoint(body, qn, k_c, v_c, e_c, wk, bk, wv, bv, use_reentrant=False)
        num, den = num + n_c, den + d_c
    out = (num / den.clamp_min(1e-30)).to(dt)
    return F.linear(merge_heads(l2_normalize(out)), out_weight.to(dt), out_bias.to(dt))
