"""2D sine positional embedding (DETR-style, normalized to 2*pi).

Port of ``unseenobjectswithmeanshift_tpu.models.position_encoding`` (ref:
MSMFormer/.../transformer_decoder/position_encoding.py). Output
[H, W, 2*num_pos_feats] with layout [y-feats | x-feats], normalized positions
(the decoder's setting); inference passes no padding mask, so the cumsum of an
all-ones mask is arange(1, N+1). The first half of the channels depends on
the row only and the second half on the column only, which
``position_embedding_sine_factors`` returns as two small tables.
"""

from __future__ import annotations

import math

import torch


def position_embedding_sine(h: int, w: int, num_pos_feats: int = 128,
                            temperature: float = 10000.0, scale: float = 2 * math.pi,
                            device="cuda"):
    f32 = torch.float32
    eps = 1e-6
    y_embed = torch.arange(1, h + 1, dtype=f32, device=device)[:, None] / (h + eps) * scale
    x_embed = torch.arange(1, w + 1, dtype=f32, device=device)[None, :] / (w + eps) * scale
    y_embed = y_embed.expand(h, w)
    x_embed = x_embed.expand(h, w)
    dim_t = torch.arange(num_pos_feats, dtype=f32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = torch.stack([pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()],
                        dim=3).reshape(h, w, num_pos_feats)
    pos_y = torch.stack([pos_y[:, :, 0::2].sin(), pos_y[:, :, 1::2].cos()],
                        dim=3).reshape(h, w, num_pos_feats)
    return torch.cat([pos_y, pos_x], dim=2)


def position_embedding_sine_factors(h: int, w: int, num_pos_feats: int = 128,
                                    device="cuda"):
    """(pos_y [F, h], pos_x [F, w]), F = num_pos_feats: the two factors of
    ``position_embedding_sine(h, w)``, whose channel j < F at pixel (y, x) is
    pos_y[j, y] and channel F + j is pos_x[j, x]. Computed by the same
    function on an h x 1 and a 1 x w grid, so the values are the same bits."""
    pos_y = position_embedding_sine(h, 1, num_pos_feats, device=device)[:, 0, :num_pos_feats]
    pos_x = position_embedding_sine(1, w, num_pos_feats, device=device)[0, :, num_pos_feats:]
    return pos_y.T.contiguous(), pos_x.T.contiguous()
