"""Swin Transformer backbone (Swin-T) with res2..res5 outputs, for ``tabletop_swin``.

Port of ``unseenobjectswithmeanshift_tpu.models.swin.SwinTransformer``
(:28-199; ref: modeling/backbone/swin.py D2SwinTransformer): a 4x4 patch
embedding with LayerNorm, four stages of window attention with a relative
position bias (every second block on windows shifted by half a window, with
the shifted-window mask), patch merging between stages, and a LayerNorm on
each output: [B, 96 | 192 | 384 | 768, H/4 .. H/32, W/4 .. W/32], NCHW.
Plain PyTorch: the JAX package computes it in XLA.

Where the reference and the JAX package differ, the port follows the
reference, whose layout published Swin checkpoints use (the JAX package's
differences are listed under "JAX-side defects" in ROADMAP.md section 3):
LayerNorm eps 1e-5 (flax's default 1e-6 there); each block pads its
normalized input to whole windows and crops after the attention (the JAX
package pads a stage's input once, so padded positions carry LayerNorm's
bias into the attention); patch merging concatenates the 2x2 neighbours in
the order x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2]. At a
size whose every stage is a whole number of windows (224 x 224) and with
the JAX order of the merged channels the two agree.

Module names are the reference checkpoint's (``patch_embed.proj``,
``layers.{s}.blocks.{b}.attn.qkv``, ``layers.{s}.downsample.reduction``,
``norm{s}``, ...); ``relative_position_index`` is computed, not stored.

The train forward is the eval forward: neither package has dropout or
drop-path here (JAX :166 takes ``train`` and uses neither). Autograd
carries the gradients through the relative-position-bias gather and the
shifted-window mask (tests/test_torch_train_standard.py, at 224 x 224).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .compute import Conv2d, LayerNorm, Linear

LN_EPS = 1e-5


@lru_cache(maxsize=None)
def relative_position_index(ws: int) -> np.ndarray:
    """[ws^2, ws^2] index into the (2 ws - 1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


@lru_cache(maxsize=None)
def shift_attn_mask(Hp: int, Wp: int, ws: int, shift: int) -> np.ndarray:
    """[num_windows, ws^2, ws^2] additive mask (0 or -100) of the shifted
    windows of an Hp x Wp map (ref: BasicLayer.forward)."""
    img = np.zeros((Hp, Wp), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    mw = img.reshape(Hp // ws, ws, Wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return np.where(mw[:, None, :] - mw[:, :, None] != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x, ws: int):
    B, H, W, C = x.shape
    x = x.view(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(windows, ws: int, H: int, W: int):
    B = windows.shape[0] // (H * W // ws // ws)
    x = windows.view(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, ws: int, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.ws = num_heads, ws
        self.relative_position_bias_table = nn.Parameter(torch.empty((2 * ws - 1) ** 2, num_heads))
        self.qkv = Linear(dim, 3 * dim, compute_dtype=dtype)
        self.proj = Linear(dim, dim, compute_dtype=dtype)

    def forward(self, x, mask=None):
        """x [B_, N, C] windows; mask [nW, N, N] or None."""
        B_, N, C = x.shape
        H = self.num_heads
        D = C // H
        q, k, v = self.qkv(x).view(B_, N, 3, H, D).permute(2, 0, 3, 1, 4)
        attn = (q * D ** -0.5) @ k.transpose(-2, -1)
        idx = torch.from_numpy(relative_position_index(self.ws)).to(x.device).view(-1)
        bias = self.relative_position_bias_table[idx].view(N, N, H).permute(2, 0, 1)
        attn = attn.float() + bias[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.view(B_ // nW, nW, H, N, N) + mask[None, :, None]).view(B_, H, N, N)
        out = (attn.softmax(-1).to(x.dtype) @ v).transpose(1, 2).reshape(B_, N, C)
        return self.proj(out)


class _Mlp(nn.Module):
    def __init__(self, dim, hidden, dtype):
        super().__init__()
        self.fc1 = Linear(dim, hidden, compute_dtype=dtype)
        self.fc2 = Linear(hidden, dim, compute_dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim, num_heads, ws=7, shift=0, mlp_ratio=4.0, dtype=torch.float32):
        super().__init__()
        self.ws, self.shift = ws, shift
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, num_heads, ws, dtype)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x):
        """x [B, H, W, C]."""
        B, H, W, C = x.shape
        ws, s = self.ws, self.shift
        h = F.pad(self.norm1(x), (0, 0, 0, (-W) % ws, 0, (-H) % ws))
        Hp, Wp = h.shape[1], h.shape[2]
        mask = None
        if s > 0:
            h = torch.roll(h, (-s, -s), dims=(1, 2))
            mask = torch.from_numpy(shift_attn_mask(Hp, Wp, ws, s)).to(x.device)
        h = window_reverse(self.attn(window_partition(h, ws), mask), ws, Hp, Wp)
        if s > 0:
            h = torch.roll(h, (s, s), dims=(1, 2))
        x = x + h[:, :H, :W]
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim, dtype=torch.float32):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, compute_dtype=dtype)

    def forward(self, x):
        B, H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      -1)
        return self.reduction(self.norm(x))


class _PatchEmbed(nn.Module):
    def __init__(self, patch, dim, dtype):
        super().__init__()
        self.patch = patch
        self.proj = Conv2d(3, dim, patch, patch, compute_dtype=dtype)
        self.norm = LayerNorm(dim, eps=LN_EPS)

    def forward(self, x):
        p = self.patch
        x = F.pad(x, (0, (-x.shape[3]) % p, 0, (-x.shape[2]) % p))
        return self.norm(self.proj(x).permute(0, 2, 3, 1))       # [B, h, w, C]


class _Stage(nn.Module):
    def __init__(self, dim, depth, heads, ws, merge, dtype):
        super().__init__()
        self.blocks = nn.ModuleList(SwinBlock(dim, heads, ws, 0 if b % 2 == 0 else ws // 2,
                                              dtype=dtype) for b in range(depth))
        self.downsample = PatchMerging(dim, dtype) if merge else None


class SwinTransformer(nn.Module):
    """Swin-T by default: embed 96, depths (2, 2, 6, 2), heads (3, 6, 12, 24),
    window 7. [B, 3, H, W] -> {"res2": ..., "res5": ...} NCHW."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 patch_size: int = 4, dtype=torch.float32):
        super().__init__()
        self.patch_embed = _PatchEmbed(patch_size, embed_dim, dtype)
        n = len(depths)
        self.layers = nn.ModuleList(
            _Stage(embed_dim * 2 ** i, depths[i], num_heads[i], window_size, i < n - 1, dtype)
            for i in range(n))
        for i in range(n):
            setattr(self, f"norm{i}", LayerNorm(embed_dim * 2 ** i, eps=LN_EPS))

    def forward(self, x):
        x = self.patch_embed(x)
        outs = {}
        for i, stage in enumerate(self.layers):
            for blk in stage.blocks:
                x = blk(x)
            outs[f"res{i + 2}"] = getattr(self, f"norm{i}")(x).permute(0, 3, 1, 2)
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs
