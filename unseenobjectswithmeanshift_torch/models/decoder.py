"""MeanShift transformer decoder (MSMFormer), 1 feature level, fused structure.

Port of ``unseenobjectswithmeanshift_tpu.models.decoder.MeanShiftDecoder``
along its fused inference path (:315-386, :396-408, :450-509), which the JAX
package takes on the TPU. Per layer (post-norm, no dropout):

  cross-attention: vMF attention of the queries over every pixel, masked by
                   the previous head's mask (me . mf < 0), with the
                   all-masked-row guard -> ops.fused_cross_attention
                   (tile_skip: skipping the key tiles no query attends to)
  self-attention:  vMF attention among the queries (plain PyTorch)
  FFN:             256 -> 2048 -> 256, relu
  decoder_block_norm: L2-normalize the query features
  heads:           class logits and mask embed (decoder_norm, class_embed,
                   mask_embed MLP)

``input_proj`` and ``level_embed`` are folded into the cross-attention's k/v
projections (:91-104): the kernel streams the 64-channel map, never a 256-d
one. Submodule names follow the reference checkpoint keys
(``transformer_cross_attention_layers.{i}.meanshift_attn``, ...), so
``state_dict()`` feeds the JAX package's converter directly.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_cross_attention import fused_uoms_cross_attention
from ..ops.hypersphere_attention import (
    l2_normalize, meanshift_attention, merge_heads, split_heads,
)
from .position_encoding import position_embedding_sine


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

    def fused_cross(self, query, featT, mfT, me, posT, win, cin, tile_skip=False,
                    tile_skip_force_all=False):
        """Cross-attention over the raw feature map. win [C, E] / cin [E]: the
        input projection's kernel and its bias plus the level embedding,
        folded into the k/v projections. tile_skip: skip the key tiles that no
        query attends to (same output bits)."""
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        qn = l2_normalize(split_heads(F.linear(query, wq, bq), self.num_heads))
        wk_io, wv_io = wk.T, wv.T                       # [in, out]
        awk, awv = win @ wk_io, win @ wv_io
        ck = cin @ wk_io + bk
        cv = cin @ wv_io + bv
        out = fused_uoms_cross_attention(
            qn.contiguous(), featT, mfT, me.contiguous(), posT, awk.contiguous(),
            awv.contiguous(), wk_io.contiguous(), ck.contiguous(), cv.contiguous(),
            kappa=self.kappa, tile_skip=tile_skip, tile_skip_force_all=tile_skip_force_all)
        return self.out_proj(merge_heads(l2_normalize(out)))


class _CrossLayer(nn.Module):
    def __init__(self, E, nheads, kappa):
        super().__init__()
        self.meanshift_attn = MeanShiftAttention(E, nheads, kappa)
        self.norm = nn.LayerNorm(E)


class _SelfLayer(nn.Module):
    def __init__(self, E, nheads, kappa):
        super().__init__()
        self.self_attn = MeanShiftAttention(E, nheads, kappa)
        self.norm = nn.LayerNorm(E)


class _FFNLayer(nn.Module):
    def __init__(self, E, ffn):
        super().__init__()
        self.linear1 = nn.Linear(E, ffn)
        self.linear2 = nn.Linear(ffn, E)
        self.norm = nn.LayerNorm(E)

    def forward(self, x):
        return self.norm(x + self.linear2(F.relu(self.linear1(x))))


class MLP(nn.Module):
    """relu MLP (ref: meanshiftformer_transformer_decoder.py:329-341)."""

    def __init__(self, in_dim, hidden_dim, output_dim, num_layers=3):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:]))

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MeanShiftDecoder(nn.Module):
    def __init__(self, num_classes=2, hidden_dim=256, num_queries=100, nheads=8,
                 dim_feedforward=2048, dec_layers=6, mask_dim=256, in_channels=64,
                 kappa=30.0, tile_skip=False, tile_skip_force_all=False):
        super().__init__()
        E, Q = hidden_dim, num_queries
        self.E, self.nheads, self.L = E, nheads, dec_layers
        self.tile_skip, self.tile_skip_force_all = tile_skip, tile_skip_force_all
        self.query_feat = nn.Embedding(Q, E)
        self.query_embed = nn.Embedding(Q, E)
        self.level_embed = nn.Embedding(1, E)
        # the reference projects only when in_channels != hidden_dim; the
        # UCN configurations (64 -> 256) always do
        if in_channels == E:
            raise ValueError("the port's decoder takes in_channels != hidden_dim")
        self.input_proj = nn.ModuleList([nn.Conv2d(in_channels, E, 1)])
        self.transformer_cross_attention_layers = nn.ModuleList(
            _CrossLayer(E, nheads, kappa) for _ in range(dec_layers))
        self.transformer_self_attention_layers = nn.ModuleList(
            _SelfLayer(E, nheads, kappa) for _ in range(dec_layers))
        self.transformer_ffn_layers = nn.ModuleList(
            _FFNLayer(E, dim_feedforward) for _ in range(dec_layers))
        self.decoder_norm = nn.LayerNorm(E)
        self.class_embed = nn.Linear(E, num_classes + 1)
        self.mask_embed = MLP(E, E, mask_dim, 3)

    def _heads(self, output):
        d = self.decoder_norm(output)
        return self.class_embed(d), self.mask_embed(d)

    def forward(self, x, mask_features, materialize_masks=False):
        """x: [B, h, w, C] feature map; mask_features: [B, h, w, Cm] (NHWC, as
        in the JAX package; NCHW-contiguous storage is used without a copy).
        Returns pred_logits [B, Q, classes+1], mask_embed [B, Q, Cm],
        aux_outputs (per-layer pred_logits) and, when materialize_masks,
        pred_masks [B, Q, h, w]."""
        B, h, w, _ = x.shape
        E = self.E
        featT = x.permute(0, 3, 1, 2).reshape(B, -1, h * w).contiguous()
        mfT = mask_features.permute(0, 3, 1, 2).reshape(B, -1, h * w).contiguous()
        posT = position_embedding_sine(h, w, E // 2, device=x.device).reshape(
            h * w, E).T.contiguous()
        proj = self.input_proj[0]
        win = proj.weight[:, :, 0, 0].T
        cin = proj.bias + self.level_embed.weight[0]

        output = self.query_feat.weight[None].expand(B, -1, -1)
        qpos = self.query_embed.weight[None].expand(B, -1, -1)
        cls, me = self._heads(output)
        aux = [cls]
        for i in range(self.L):
            ca = self.transformer_cross_attention_layers[i]
            output = ca.norm(output + ca.meanshift_attn.fused_cross(
                output + qpos, featT, mfT, me, posT, win, cin, self.tile_skip,
                self.tile_skip_force_all))
            sa = self.transformer_self_attention_layers[i]
            qk = output + qpos
            output = sa.norm(output + sa.self_attn(qk, qk, output))
            output = self.transformer_ffn_layers[i](output)
            output = l2_normalize(output, dim=-1)        # decoder_block_norm
            cls, me = self._heads(output)
            aux.append(cls)
        out = {"pred_logits": cls, "mask_embed": me,
               "aux_outputs": [{"pred_logits": c} for c in aux[:-1]]}
        if materialize_masks:
            out["pred_masks"] = torch.einsum("bqc,bck->bqk", me, mfT).reshape(
                B, -1, h, w)
        return out
