"""Point sampling on mask logits (detectron2 point_rend equivalents).

Port of ``unseenobjectswithmeanshift_tpu.losses.point_sample`` (ref:
modeling/matcher.py:122-132, modeling/criterion.py:161-181):

- ``point_sample``: bilinear sampling at normalized (x, y) in [0, 1]^2 with
  ``F.grid_sample(2p - 1, align_corners=False, padding_mode='zeros')``
  semantics: src = p * size - 0.5, out-of-range neighbours contribute zero.
- ``get_uncertain_point_coords_with_randomness``: importance sampling of
  uncertain points (oversample 3.0, top 75% by -|logit| plus 25% fresh
  uniform points).

``build_sample_window`` keeps the maps zero-padded by one pixel on every
side, [N, H + 2, W + 2], and ``point_sample`` gathers the four taps from it:
the anchor (y0 + 1, x0 + 1) always lies inside the padded map, so no range
masks are needed. (The JAX package stacks the four taps into a
[N, H + 1, W + 1, 4] window, one contiguous row a point on the TPU; the taps
and their weights are the same here.)

Every random draw is an argument: ``draw_point_coords`` makes them from a
``torch.Generator``, and a caller (the CPU tests) may pass the JAX package's
own draws instead.
"""

from __future__ import annotations

from typing import Optional

import torch


def build_sample_window(masks, dtype: Optional[torch.dtype] = None):
    """[N, H, W] maps -> [N, H + 2, W + 2], zero-padded by one pixel, in
    ``dtype`` when given (bf16 is exact for 0/1 targets). Build it once when
    the same maps are sampled at several point sets (the gt masks across the
    deep-supervision heads)."""
    masks = masks if dtype is None else masks.to(dtype)
    return torch.nn.functional.pad(masks, (1, 1, 1, 1))


def point_sample(masks, points, win=None):
    """Sample [N, H, W] maps (or their window ``win`` from
    build_sample_window) at points [N, P, 2] (x, y) in [0, 1]. Returns
    [N, P] fp32; the four taps are read in the window's dtype and weighted in
    fp32."""
    if win is None:
        win = build_sample_window(masks)
    N, Hp, Wp = win.shape
    H, W = Hp - 2, Wp - 2
    fx = points[..., 0] * W - 0.5
    fy = points[..., 1] * H - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = fx - x0, fy - y0
    base = ((y0.long() + 1) * Wp + (x0.long() + 1))             # [N, P]
    flat = win.reshape(N, Hp * Wp)
    taps = [torch.gather(flat, 1, base + off).float() for off in (0, 1, Wp, Wp + 1)]
    return (taps[0] * ((1 - wy) * (1 - wx)) + taps[1] * ((1 - wy) * wx)
            + taps[2] * (wy * (1 - wx)) + taps[3] * (wy * wx))


def calculate_uncertainty(logits):
    """-|logit|: most uncertain where the logit is near 0 (ref:
    criterion.py:73-87)."""
    return -logits.abs()


def importance_sample_sizes(num_points: int, oversample_ratio: float,
                            importance_sample_ratio: float):
    """(num_sampled, num_uncertain, num_random) of the importance sampling."""
    num_sampled = int(num_points * oversample_ratio)
    num_uncertain = int(importance_sample_ratio * num_points)
    return num_sampled, num_uncertain, num_points - num_uncertain


def draw_point_coords(n_rows: int, num_points: int, oversample_ratio: float,
                      importance_sample_ratio: float, generator: torch.Generator,
                      device):
    """The uniform draws of one importance sampling: (coords
    [n_rows, num_sampled, 2], rand [n_rows, num_random, 2])."""
    num_sampled, _, num_random = importance_sample_sizes(
        num_points, oversample_ratio, importance_sample_ratio)
    coords = torch.rand(n_rows, num_sampled, 2, generator=generator, device=device)
    rand = torch.rand(n_rows, num_random, 2, generator=generator, device=device)
    return coords, rand


def get_uncertain_point_coords_with_randomness(mask_logits, num_points: int,
                                               oversample_ratio: float,
                                               importance_sample_ratio: float,
                                               coords, rand, row_idx=None):
    """mask_logits [N, H, W] -> [N, num_points, 2] (x, y) in [0, 1]: the
    importance_sample_ratio share of num_points with the highest uncertainty
    among the ``coords`` candidates, then the ``rand`` points. coords / rand
    are drawn for every row of the uncompacted set (draw_point_coords);
    row_idx picks the rows of mask_logits from them, so pair compaction does
    not change the points of a surviving row."""
    _, num_uncertain, _ = importance_sample_sizes(num_points, oversample_ratio,
                                                  importance_sample_ratio)
    if row_idx is not None:
        coords, rand = coords[row_idx], rand[row_idx]
    unc = calculate_uncertainty(point_sample(mask_logits, coords))
    idx = torch.topk(unc, num_uncertain, dim=1).indices
    picked = torch.gather(coords, 1, idx[..., None].expand(-1, -1, 2))
    return torch.cat([picked, rand], dim=1)


def point_sample_features(features, points):
    """Bilinearly sample [B, H, W, C] feature maps at points [B, P, 2] ->
    [B, P, C], grid_sample semantics: four row gathers of C channels, each
    tap zero outside the map."""
    B, H, W, C = features.shape
    fx = points[..., 0] * W - 0.5
    fy = points[..., 1] * H - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = (fx - x0)[..., None], (fy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    flat = features.reshape(B, H * W, C)

    def tap(yi, xi, w):
        inb = ((yi >= 0) & (yi < H) & (xi >= 0) & (xi < W))[..., None]
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))[..., None].expand(-1, -1, C)
        return torch.where(inb, torch.gather(flat, 1, idx), 0.0) * w

    return (tap(y0, x0, (1 - wy) * (1 - wx)) + tap(y0, x0 + 1, (1 - wy) * wx)
            + tap(y0 + 1, x0, wy * (1 - wx)) + tap(y0 + 1, x0 + 1, wy * wx))


def point_sample_factored(mask_embed, mask_features, points):
    """The maps mask_embed [B, N, C] x mask_features [B, H, W, C] sampled at
    points [B, P, 2] shared by the N maps of an image -> [B, N, P] fp32
    (bilinear sampling commutes with the channel contraction)."""
    pts = point_sample_features(mask_features, points).float()
    return torch.einsum("bnc,bpc->bnp", mask_embed.float(), pts)
