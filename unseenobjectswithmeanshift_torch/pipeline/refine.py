"""Stage-2 zoom-in refinement: RoI crops and paste-back, in PyTorch.

Port of ``unseenobjectswithmeanshift_tpu.pipeline.refine`` (crop_rois :92,
match_label_crop :135, compact_present :236; ref: lib/fcn/test_dataset.py
crop_rois:62-112, match_label_crop:116-179). The JAX package samples with
selector matmuls because gathers are slow on a TPU; here the same taps and the
same weights are gathered directly. Everything stays on the device: no host
round-trip per crop.

Conventions kept: crops are sampled bilinearly with align_corners=True (rgb,
xyz) and floor-nearest (the stage-1 mask); the paste-back is floor-nearest.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class Crops:
    rgb: torch.Tensor              # [T, S, S, 3]
    mask: torch.Tensor             # [T, S, S] float 0/1 (stage-1 mask crop)
    xyz: Optional[torch.Tensor]    # [T, S, S, 3] or None
    rois: torch.Tensor             # [T, 4] int64 (x_min, y_min, x_max, y_max)
    present: torch.Tensor          # [T] bool


def _tight_boxes(masks):
    """masks [T, H, W] bool -> (x_min, y_min, x_max, y_max) [T] each, zeros
    for empty masks (mask_to_tight_box)."""
    T, H, W = masks.shape
    any_row, any_col = masks.any(dim=2), masks.any(dim=1)
    ridx = torch.arange(H, device=masks.device)
    cidx = torch.arange(W, device=masks.device)
    y_min = torch.where(any_row, ridx, H).amin(1)
    y_max = torch.where(any_row, ridx, -1).amax(1)
    x_min = torch.where(any_col, cidx, W).amin(1)
    x_max = torch.where(any_col, cidx, -1).amax(1)
    empty = ~any_row.any(1)
    zero = torch.zeros_like(y_min)
    return tuple(torch.where(empty, zero, v) for v in (x_min, y_min, x_max, y_max))


def _bilinear_taps(lo, hi, size: int, S: int):
    """align_corners=True taps over [lo, hi] -> (i0, i1, w0, w1), each [T, S].
    Where both taps coincide (the last row of the image) the single weight is
    (1 - w) + w, as the JAX package's selector matrix sums it."""
    f = (hi - lo).float() / (S - 1)
    src = lo.float()[:, None] + torch.arange(S, device=lo.device, dtype=torch.float32) * f[:, None]
    i0 = torch.floor(src).long()
    i1 = torch.clamp(i0 + 1, max=size - 1)
    w = src - i0.float()
    same = i0 == i1
    w0 = torch.where(same, (1 - w) + w, 1 - w)
    w1 = torch.where(same, torch.zeros_like(w), w)
    return i0, i1, w0, w1


def crop_rois(image, label, xyz, max_instances: int, crop_size: int = 224,
              padding: float = 0.25) -> Crops:
    """image [H, W, 3]; label [H, W] int (values 0 and 2..max_instances+1);
    xyz [H, W, 3] or None. Slot t holds label value t+2."""
    H, W = label.shape
    T, S = max_instances, crop_size
    dev = label.device
    values = torch.arange(2, T + 2, device=dev)
    masks = label[None] == values[:, None, None]                  # [T, H, W]
    present = masks.flatten(1).any(1)
    x_min, y_min, x_max, y_max = _tight_boxes(masks)
    # pad 25% per side (round half to even, as torch.round), clamp to the image
    xp = torch.round((x_max - x_min).float() * padding).long()
    yp = torch.round((y_max - y_min).float() * padding).long()
    x_min, x_max = (x_min - xp).clamp_min(0), (x_max + xp).clamp_max(W - 1)
    y_min, y_max = (y_min - yp).clamp_min(0), (y_max + yp).clamp_max(H - 1)

    ar = torch.arange(S, device=dev)
    ny = y_min[:, None] + (ar * (y_max - y_min + 1)[:, None]) // S   # [T, S]
    nx = x_min[:, None] + (ar * (x_max - x_min + 1)[:, None]) // S
    tt = torch.arange(T, device=dev)[:, None, None]
    m = masks[tt, ny[:, :, None], nx[:, None, :]].float()          # [T, S, S]

    src = image if xyz is None else torch.cat([image, xyz], dim=-1)
    y0, y1, wy0, wy1 = _bilinear_taps(y_min, y_max, H, S)
    x0, x1, wx0, wx1 = _bilinear_taps(x_min, x_max, W, S)
    rows = (wy0[..., None, None] * src[y0] + wy1[..., None, None] * src[y1])  # [T, S, W, c]
    ti = torch.arange(T, device=dev)[:, None, None]
    si = ar[None, :, None]
    both = (wx0[:, None, :, None] * rows[ti, si, x0[:, None, :]]
            + wx1[:, None, :, None] * rows[ti, si, x1[:, None, :]])     # [T, S, S, c]

    keep = present[:, None, None, None]
    both = torch.where(keep, both, torch.zeros_like(both))
    m = torch.where(present[:, None, None], m, torch.zeros_like(m))
    rgb = both[..., :3]
    dep = None if xyz is None else both[..., 3:]
    rois = torch.stack([x_min, y_min, x_max, y_max], dim=1)
    return Crops(rgb=rgb, mask=m, xyz=dep, rois=rois, present=present)


def match_label_crop(labels_crop, stage1_mask_crop, rois, depth_crop, present,
                     image_hw, overlap_threshold: float = 0.5):
    """Merge per-crop label images into one refined [H, W] label image.

    1. per crop, drop segments overlapping the stage-1 mask by < 50%
    2. paste crops by mean valid depth of kept pixels, farthest first (by RoI
       area without depth)
    3. renumber kept segments from 1 in paste order; floor-nearest paste into
       each RoI box, later pastes overwriting nonzero pixels.
    labels_crop [T, S, S] int; stage1_mask_crop [T, S, S]; rois [T, 4];
    depth_crop [T, S, S] or None; present [T] bool. Crop label values of
    T+2 and above belong to no segment, as the JAX package's one-hot over
    T+2 values drops them (UCN crops carry labels up to num_seeds + 1).
    """
    T, S, _ = labels_crop.shape
    V = T + 2
    H, W = image_hw
    dev = labels_crop.device
    lab = labels_crop.long()
    onehot = lab[:, None] == torch.arange(V, device=dev)[None, :, None, None]  # [T,V,S,S]
    seg_sizes = onehot.flatten(2).sum(-1).float()
    overlap = (onehot * stage1_mask_crop[:, None]).flatten(2).sum(-1)
    pct = overlap / seg_sizes.clamp_min(1.0)
    keep = (seg_sizes > 0) & (pct >= overlap_threshold) & present[:, None]     # [T, V]
    cols = lab.clamp(max=V).flatten(1)     # column V of the lookups: no segment

    if depth_crop is not None:
        kept_pixels = torch.gather(torch.cat([keep, keep.new_zeros(T, 1)], 1), 1,
                                   cols).reshape(T, S, S)
        has_kept = kept_pixels.flatten(1).any(1)
        sel = torch.where(has_kept[:, None, None], kept_pixels, torch.ones_like(kept_pixels))
        dpos = sel & (depth_crop > 0)
        dsum = (depth_crop * dpos).flatten(1).sum(1)
        dcnt = dpos.flatten(1).sum(1)
        sort_key = torch.where(dcnt > 0, dsum / dcnt.clamp_min(1),
                               torch.full_like(dsum, float("inf")))
    else:
        sort_key = ((rois[:, 2] - rois[:, 0] + 1) * (rois[:, 3] - rois[:, 1] + 1)).float()
    order = torch.argsort(-sort_key, stable=True)

    kept_counts = keep.sum(-1)
    offsets_in_order = torch.cumsum(kept_counts[order], 0) - kept_counts[order]
    offsets = torch.empty_like(offsets_in_order)
    offsets[order] = offsets_in_order
    rank = torch.cumsum(keep.long(), dim=1)
    lookup = torch.where(keep, offsets[:, None] + rank, torch.zeros_like(rank))  # [T, V]
    relabeled = torch.gather(torch.cat([lookup, lookup.new_zeros(T, 1)], 1), 1,
                             cols).reshape(T, S, S)

    Y = torch.arange(H, device=dev)
    X = torch.arange(W, device=dev)
    refined = torch.zeros((H, W), dtype=torch.int32, device=dev)
    for j in range(T):
        i = order[j]
        x_min, y_min, x_max, y_max = rois[i].unbind()
        oh = (y_max - y_min + 1).clamp_min(1)
        ow = (x_max - x_min + 1).clamp_min(1)
        cy = torch.clamp(((Y - y_min) * S) // oh, 0, S - 1)
        cx = torch.clamp(((X - x_min) * S) // ow, 0, S - 1)
        in_box = (((Y >= y_min) & (Y <= y_max))[:, None]
                  & ((X >= x_min) & (X <= x_max))[None, :])
        vals = relabeled[i][cy[:, None], cx[None, :]].to(torch.int32)
        write = (vals > 0) & in_box & present[i]
        refined = torch.where(write, vals, refined)
    return refined
