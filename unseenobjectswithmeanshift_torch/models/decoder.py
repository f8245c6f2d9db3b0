"""MeanShift transformer decoder (MSMFormer), 1 or 3 feature levels, fused structure.

Port of ``unseenobjectswithmeanshift_tpu.models.decoder.MeanShiftDecoder``
along its fused inference path (:315-386, :396-408, :450-509), which the JAX
package takes on the TPU. Per layer (post-norm, no dropout):

  cross-attention: vMF attention of the queries over every pixel, masked by
                   the previous head's mask (me . mf < 0), with the
                   all-masked-row guard -> ops.fused_cross_attention
                   (tile_skip: skipping the key tiles no query attends to)
  self-attention:  vMF attention among the queries (plain PyTorch)
  FFN:             256 -> 2048 -> 256, relu
  decoder_block_norm: L2-normalize the query features (when set)
  heads:           class logits and mask embed (decoder_norm, class_embed,
                   mask_embed MLP)

``key_stride`` s > 1 (an opt-in for serving, :323-369 and :416-419): the
cross-attention's keys are the strided subsample [::s, ::s] of the
full-resolution map, each with the feature and the positional encoding it has
at stride 1 (the sine factors are computed at the full size, then strided);
the masks stay full resolution.

``num_feature_levels`` L (1 for the UCN backbone, 3 for the standard
backbones' pyramid, :296-509): one input projection and one level embedding
per level; layer i attends level i % L, whose keys are that level's pixels
and whose mask comes from the mask features resized once per level to the
level's size (bilinear, align_corners=False, :370-374).

``input_proj`` and ``level_embed`` are folded into the cross-attention's k/v
projections (:91-104): the kernel streams the 64-channel map, never a 256-d
one.

Training takes the unfused path instead (``forward_unfused``, JAX
:333-351, :409-424): the same parameters, the input projection and level
embedding applied to the map, the masked cross-attention in plain PyTorch
(``MeanShiftAttention.masked``: dense, or chunked from 32,768 keys on).

``dtype`` is the compute dtype (``models/compute.py``), as the JAX
decoder's (:285-509): the queries, LayerNorms, self-attention, FFN and heads
run in it, and so does the cross-attention kernel, whose every input
(``featT``, ``mfT``, ``me``, ``qn``, the folded projections, the positional
factors) reaches it in that dtype. The folded projections are computed in
fp32 and then cast (:96-104). The positional factors are the fp32 sine
factors cast to the compute dtype: in bf16 the same values as the JAX
package's ``posT.astype(bf16)``, key by key; the kernel's per-row and
per-column tables built from them are fp32, as the JAX kernel's projected
``PT`` is. Submodule names follow the reference checkpoint keys
(``transformer_cross_attention_layers.{i}.meanshift_attn``, ...), so
``state_dict()`` feeds the JAX package's converter directly.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.fused_cross_attention import fused_uoms_cross_attention
from ..ops.hypersphere_attention import (
    CHUNKED_ATTENTION_MIN_K, bool_mask_to_bias, chunked_masked_meanshift_attention_twopass,
    l2_normalize, meanshift_attention, merge_heads, split_heads,
)
from ..ops.resize import resize_bilinear
from .compute import LayerNorm, Linear
from .position_encoding import position_embedding_sine, position_embedding_sine_factors


class MeanShiftAttention(nn.Module):
    """Packed in-projection + out-projection, as torch nn.MultiheadAttention
    names them (``in_proj_weight`` [3E, E], ``in_proj_bias``, ``out_proj``)."""

    def __init__(self, embed_dim: int, num_heads: int, kappa: float = 30.0):
        super().__init__()
        self.num_heads, self.kappa = num_heads, kappa
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query, key, value):
        out, _ = meanshift_attention(query, key, value, self.in_proj_weight,
                                     self.in_proj_bias, self.out_proj.weight,
                                     self.out_proj.bias, self.num_heads, self.kappa)
        return out

    def masked(self, query, key, value, keep):
        """The unfused masked cross-attention (training): keep [B, Q, K]
        bool, the mask logits' (me . mf >= 0), with the all-masked-row guard;
        dense below CHUNKED_ATTENTION_MIN_K keys, the chunked two-pass form
        from there on (JAX decoder.py:166-188)."""
        args = (self.in_proj_weight, self.in_proj_bias, self.out_proj.weight,
                self.out_proj.bias, self.num_heads)
        if key.shape[1] >= CHUNKED_ATTENTION_MIN_K:
            return chunked_masked_meanshift_attention_twopass(
                query, key, value, *args, keep, kappa=self.kappa)
        out, _ = meanshift_attention(query, key, value, *args, self.kappa,
                                     mask_bias=bool_mask_to_bias(~keep))
        return out

    def fused_cross(self, query, featT, mfT, me, pos, win, cin, tile_skip=False,
                    tile_skip_force_all=False):
        """Cross-attention over the raw feature map. pos: the positional
        encoding as posT [E, K] or as its sine factors (pos_y, pos_x), which
        the kernel projects per row and column instead of per key. win
        [C, E] / cin [E]: the input projection's kernel and its bias plus the
        level embedding, folded into the k/v projections. tile_skip: skip the
        key tiles that no query attends to (same output bits). Computes in
        the query's dtype; the folded projections in fp32, then cast."""
        dt = query.dtype
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        qn = l2_normalize(split_heads(F.linear(query, wq.to(dt), bq.to(dt)), self.num_heads))
        wk_io, wv_io = wk.T, wv.T                       # [in, out]
        awk, awv = (win @ wk_io).to(dt), (win @ wv_io).to(dt)
        ck = (cin @ wk_io + bk).to(dt)
        cv = (cin @ wv_io + bv).to(dt)
        out = fused_uoms_cross_attention(
            qn.contiguous(), featT, mfT, me.contiguous(), pos, awk.contiguous(),
            awv.contiguous(), wk_io.to(dt).contiguous(), ck.contiguous(), cv.contiguous(),
            kappa=self.kappa, tile_skip=tile_skip, tile_skip_force_all=tile_skip_force_all)
        return F.linear(merge_heads(l2_normalize(out)), self.out_proj.weight.to(dt),
                        self.out_proj.bias.to(dt))


class _CrossLayer(nn.Module):
    def __init__(self, E, nheads, kappa):
        super().__init__()
        self.meanshift_attn = MeanShiftAttention(E, nheads, kappa)
        self.norm = LayerNorm(E)


class _SelfLayer(nn.Module):
    def __init__(self, E, nheads, kappa):
        super().__init__()
        self.self_attn = MeanShiftAttention(E, nheads, kappa)
        self.norm = LayerNorm(E)


class _FFNLayer(nn.Module):
    def __init__(self, E, ffn, dtype):
        super().__init__()
        self.linear1 = Linear(E, ffn, compute_dtype=dtype)
        self.linear2 = Linear(ffn, E, compute_dtype=dtype)
        self.norm = LayerNorm(E)

    def forward(self, x):
        return self.norm(x + self.linear2(F.relu(self.linear1(x))))


class MLP(nn.Module):
    """relu MLP (ref: meanshiftformer_transformer_decoder.py:329-341)."""

    def __init__(self, in_dim, hidden_dim, output_dim, num_layers=3, dtype=torch.float32):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(Linear(a, b, compute_dtype=dtype)
                                    for a, b in zip(dims, dims[1:]))

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MeanShiftDecoder(nn.Module):
    def __init__(self, num_classes=2, hidden_dim=256, num_queries=100, nheads=8,
                 dim_feedforward=2048, dec_layers=6, mask_dim=256, in_channels=64,
                 kappa=30.0, tile_skip=False, tile_skip_force_all=False,
                 key_stride: int = 1, decoder_block_norm: bool = True,
                 num_feature_levels: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        E, Q = hidden_dim, num_queries
        self.E, self.nheads, self.L, self.dtype = E, nheads, dec_layers, dtype
        self.num_levels = num_feature_levels
        self.tile_skip, self.tile_skip_force_all = tile_skip, tile_skip_force_all
        if key_stride < 1:
            raise ValueError(f"key_stride must be >= 1, got {key_stride}")
        if key_stride > 1 and num_feature_levels != 1:
            raise ValueError("key_stride applies to the 1-level (UCN) configs only; the R50 "
                             "pyramid levels are already strided")
        self.key_stride, self.block_norm = key_stride, decoder_block_norm
        self.query_feat = nn.Embedding(Q, E)
        self.query_embed = nn.Embedding(Q, E)
        self.level_embed = nn.Embedding(num_feature_levels, E)
        # the reference projects when in_channels != hidden_dim or
        # decoder.enforce_input_project; every preset (64 -> 256) does, so
        # enforce_input_project changes nothing here. Without a projection
        # the kernel would stream hidden_dim channels.
        if in_channels == E:
            raise ValueError(f"in_channels == hidden_dim ({E}): the decoder without an input "
                             "projection is not ported (ROADMAP queue 1 item 10, the "
                             "standard-backbone family)")
        self.input_proj = nn.ModuleList(nn.Conv2d(in_channels, E, 1)
                                        for _ in range(num_feature_levels))
        self.transformer_cross_attention_layers = nn.ModuleList(
            _CrossLayer(E, nheads, kappa) for _ in range(dec_layers))
        self.transformer_self_attention_layers = nn.ModuleList(
            _SelfLayer(E, nheads, kappa) for _ in range(dec_layers))
        self.transformer_ffn_layers = nn.ModuleList(
            _FFNLayer(E, dim_feedforward, dtype) for _ in range(dec_layers))
        self.decoder_norm = LayerNorm(E)
        self.class_embed = Linear(E, num_classes + 1, compute_dtype=dtype)
        self.mask_embed = MLP(E, E, mask_dim, 3, dtype)

    def _heads(self, output):
        d = self.decoder_norm(output)
        return self.class_embed(d), self.mask_embed(d)

    def _level(self, l, x, mask_features):
        """The cross-attention inputs of level l: (featT, mfT at the keys,
        positional factors, win, cin). x: [B, h, w, C] in the compute dtype."""
        B, h, w, _ = x.shape
        s, dt = self.key_stride, self.dtype
        pos_y, pos_x = position_embedding_sine_factors(h, w, self.E // 2, device=x.device)
        mf = mask_features
        if s > 1:
            x, mf = x[:, ::s, ::s], mf[:, ::s, ::s]
            if mf.shape[1:3] != x.shape[1:3]:
                raise ValueError(f"key_stride={s}: strided mask_features "
                                 f"{tuple(mf.shape[1:3])} do not match the strided "
                                 f"feature level {tuple(x.shape[1:3])}; key_stride requires "
                                 "mask_features at the feature-map resolution")
            pos_y, pos_x = pos_y[:, ::s].contiguous(), pos_x[:, ::s].contiguous()
        elif mf.shape[1:3] != (h, w):
            # resize(me . mf) == me . resize(mf): one resize of the mask
            # features per level replaces the reference's per-layer resize
            # of the mask logits (JAX decoder.py:370-374)
            mf = resize_bilinear(mf, (h, w), align_corners=False)
        hk, wk = x.shape[1], x.shape[2]
        featT = x.permute(0, 3, 1, 2).reshape(B, -1, hk * wk).contiguous()
        mfT = mf.permute(0, 3, 1, 2).reshape(B, -1, hk * wk).contiguous()
        proj = self.input_proj[l]
        return (featT, mfT, (pos_y.to(dt), pos_x.to(dt)), proj.weight[:, :, 0, 0].T,
                proj.bias + self.level_embed.weight[l])

    def forward(self, x, mask_features, materialize_masks=False):
        """x: [B, h, w, C] feature map, or a list of num_feature_levels of
        them (lowest resolution first); mask_features: [B, H, W, Cm] (NHWC,
        as in the JAX package; NCHW-contiguous storage is used without a
        copy). Layer i attends level i % num_feature_levels, its mask from
        the mask features resized to that level. Returns pred_logits
        [B, Q, classes+1], mask_embed [B, Q, Cm], aux_outputs (per-layer
        pred_logits) and, when materialize_masks, pred_masks [B, Q, H, W]
        (at the mask features' resolution, at any key_stride), all in the
        compute dtype."""
        levels = [x] if isinstance(x, torch.Tensor) else list(x)
        if len(levels) != self.num_levels:
            raise ValueError(f"the decoder takes {self.num_levels} feature levels, "
                             f"got {len(levels)}")
        B, dt = levels[0].shape[0], self.dtype
        mask_features = mask_features.to(dt)
        inputs = [self._level(l, x.to(dt), mask_features) for l, x in enumerate(levels)]

        output = self.query_feat.weight.to(dt)[None].expand(B, -1, -1)
        qpos = self.query_embed.weight.to(dt)[None].expand(B, -1, -1)
        cls, me = self._heads(output)
        aux = [cls]
        for i in range(self.L):
            featT, mfT, pos, win, cin = inputs[i % self.num_levels]
            ca = self.transformer_cross_attention_layers[i]
            output = ca.norm(output + ca.meanshift_attn.fused_cross(
                output + qpos, featT, mfT, me, pos, win, cin, self.tile_skip,
                self.tile_skip_force_all))
            sa = self.transformer_self_attention_layers[i]
            qk = output + qpos
            output = sa.norm(output + sa.self_attn(qk, qk, output))
            output = self.transformer_ffn_layers[i](output)
            if self.block_norm:
                output = l2_normalize(output, dim=-1)
            cls, me = self._heads(output)
            aux.append(cls)
        out = {"pred_logits": cls, "mask_embed": me,
               "aux_outputs": [{"pred_logits": c} for c in aux[:-1]]}
        if materialize_masks:
            _, H, W, Cm = mask_features.shape
            mfT = mask_features.permute(0, 3, 1, 2).reshape(B, Cm, H * W)
            out["pred_masks"] = torch.einsum("bqc,bck->bqk", me, mfT).reshape(B, -1, H, W)
        return out

    def forward_unfused(self, x, mask_features, materialize_masks=False, remat=False):
        """The unfused path (JAX decoder.py:333-351, :409-424, :466-469,
        :510-519), the one the JAX package trains: the input projection and
        the level embedding are applied to the feature map (src), the keys
        are src + the sine encoding, and each layer's mask logits me . mf
        (at the next level's size, detached) mask the next cross-attention
        (``MeanShiftAttention.masked``). The parameters are the fused path's:
        weights trained here serve fused unchanged, and in eval mode both
        paths compute the same function. remat: run every attention under
        ``torch.utils.checkpoint`` (the JAX ``remat``, decoder.py:442).

        Returns pred_logits, mask_embed and aux_outputs (pred_logits and
        mask_embed of every earlier layer); with materialize_masks also each
        layer's pred_masks [B, Q, H, W], detached (training scores masks in
        factored form, mask_embed x mask_features, and never holds the
        per-layer maps in the autograd graph)."""
        levels = [x] if isinstance(x, torch.Tensor) else list(x)
        if len(levels) != self.num_levels:
            raise ValueError(f"the decoder takes {self.num_levels} feature levels, "
                             f"got {len(levels)}")
        B, dt, E, s = levels[0].shape[0], self.dtype, self.E, self.key_stride
        mask_features = mask_features.to(dt)
        srcs, keys, sizes = [], [], []
        for l, xl in enumerate(levels):
            h, w = xl.shape[1:3]
            pos = position_embedding_sine(h, w, E // 2, device=xl.device)
            if s > 1:
                xl, pos = xl[:, ::s, ::s], pos[::s, ::s]
            h, w = xl.shape[1:3]
            sizes.append((h, w))
            proj = self.input_proj[l]
            src = F.linear(xl.to(dt), proj.weight[:, :, 0, 0].to(dt), proj.bias.to(dt))
            src = src.reshape(B, h * w, E) + self.level_embed.weight[l].to(dt)
            srcs.append(src)
            keys.append(src + pos.reshape(1, h * w, E).to(dt))

        def heads(output, size):
            cls, me = self._heads(output)
            with torch.no_grad():
                m = torch.einsum("bqc,bhwc->bqhw", me, mask_features)
                logits = m
                if s > 1:
                    logits = m[:, :, ::s, ::s]
                elif tuple(size) != tuple(m.shape[-2:]):
                    logits = resize_bilinear(m[..., None], size)[..., 0]
                keep = logits.reshape(B, logits.shape[1], -1) >= 0
            return cls, me, m if materialize_masks else None, keep

        def run(fn, *args):
            return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

        output = self.query_feat.weight.to(dt)[None].expand(B, -1, -1)
        qpos = self.query_embed.weight.to(dt)[None].expand(B, -1, -1)
        cls, me, m, keep = heads(output, sizes[0])
        preds = [(cls, me, m)]
        for i in range(self.L):
            l = i % self.num_levels
            ca = self.transformer_cross_attention_layers[i]
            output = ca.norm(output + run(ca.meanshift_attn.masked, output + qpos, keys[l],
                                          srcs[l], keep))
            sa = self.transformer_self_attention_layers[i]
            qk = output + qpos
            output = sa.norm(output + run(sa.self_attn, qk, qk, output))
            output = self.transformer_ffn_layers[i](output)
            if self.block_norm:
                output = l2_normalize(output, dim=-1)
            cls, me, m, keep = heads(output, sizes[(i + 1) % self.num_levels])
            preds.append((cls, me, m))

        def head(c, e, mk):
            return {"pred_logits": c, "mask_embed": e, **(
                {"pred_masks": mk} if materialize_masks else {})}

        return {**head(*preds[-1]), "aux_outputs": [head(*p) for p in preds[:-1]]}
