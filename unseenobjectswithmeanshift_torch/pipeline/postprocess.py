"""Instance post-processing for one image, in PyTorch.

Port of ``unseenobjectswithmeanshift_tpu.pipeline.postprocess``:
instance_inference (ref: pretrained_meanshiftformer_model.py:461-497),
get_confident_instances (test_utils.py:35-52), combine_masks
(test_utils.py:93-112), filter_labels_depth (test_dataset.py:183-198) and
renumber_labels_by_size (the UCN path's size-ordered crop slots).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..ops.resize import resize_bilinear


@dataclass
class Instances:
    """Fixed-size instance set (T = top-k detections)."""

    masks: torch.Tensor        # [T, H, W] bool (mask logits > 0)
    mask_logits: torch.Tensor  # [T, H, W] float
    scores: torch.Tensor       # [T] class score * mean mask probability
    classes: torch.Tensor      # [T] int64
    valid: torch.Tensor        # [T] bool


def instance_inference(pred_logits, pred_masks, num_classes: int, topk: int,
                       mask_embed=None, mask_features=None, out_hw=None) -> Instances:
    """pred_logits [Q, K+1]; pred_masks [Q, H, W] logits, or None with
    mask_embed [Q, C] and mask_features [H, W, C], in which case the masks are
    computed for the selected queries only. Returns topk instances in
    descending class-score order (ties: lower index first, as lax.top_k)."""
    scores = torch.softmax(pred_logits.float(), dim=-1)[:, :-1]
    flat = scores.reshape(-1)
    scores_per_image, topk_idx = torch.sort(flat, descending=True, stable=True)
    scores_per_image, topk_idx = scores_per_image[:topk], topk_idx[:topk]
    labels = topk_idx % num_classes
    query_idx = torch.div(topk_idx, num_classes, rounding_mode="floor")
    if pred_masks is None:
        mask_logits = torch.einsum("tc,hwc->thw", mask_embed[query_idx], mask_features)
        if out_hw is not None and tuple(mask_logits.shape[-2:]) != tuple(out_hw):
            mask_logits = resize_bilinear(mask_logits[..., None], out_hw)[..., 0]
    else:
        mask_logits = pred_masks[query_idx]
    masks = mask_logits > 0
    probs = torch.sigmoid(mask_logits)
    mask_scores = (probs * masks).float().sum((-1, -2)) / (
        masks.float().sum((-1, -2)) + 1e-6)
    final = scores_per_image * mask_scores
    return Instances(masks, mask_logits, final, labels,
                     torch.ones_like(final, dtype=torch.bool))


def get_confident_instances(inst: Instances, topk: bool = True, score: float = 0.7,
                            num_classes: int = 2, low_threshold: float = 0.4) -> Instances:
    """topk=True: keep class 1 with score > low_threshold; else score > score."""
    if topk and num_classes >= 2:
        valid = (inst.classes == 1) & (inst.scores > low_threshold)
    elif topk:
        valid = inst.valid
    else:
        valid = inst.scores > score
    return replace(inst, valid=valid & inst.valid)


def combine_masks(inst: Instances) -> torch.Tensor:
    """[H, W] int32 label image: valid instance k (in slot order) gets label
    k+2, later instances overwrite earlier ones."""
    v = inst.valid.to(torch.int32)
    ids = (torch.cumsum(v, 0) + 1) * v
    stamped = inst.masks.to(torch.int32) * ids[:, None, None]
    return stamped.amax(dim=0).to(torch.int32)


def _in_range(label, max_label: int):
    """(flat labels with those outside [0, max_label) set to 0, mask of the
    labels inside). The JAX package's one-hot over max_label values gives an
    outside label no bin, so it counts nowhere and maps to 0."""
    flat = label.reshape(-1).long()
    inside = (flat >= 0) & (flat < max_label)
    return torch.where(inside, flat, 0), inside


def filter_labels_depth(label, xyz_z, threshold: float, max_label: int):
    """Zero out labels whose fraction of valid-depth (z > 0) pixels is below
    threshold. label: [H, W] int; values outside [0, max_label) become 0."""
    flat, inside = _in_range(label, max_label)
    sizes = torch.bincount(flat[inside], minlength=max_label)
    valid_depth = torch.bincount(flat[inside & (xyz_z.reshape(-1) > 0)], minlength=max_label)
    frac = valid_depth.float() / sizes.clamp_min(1).float()
    keep = frac >= threshold
    keep[0] = True
    keep_pix = (keep[flat] & inside).reshape(label.shape)
    return torch.where(keep_pix, label, torch.zeros_like(label))


def renumber_labels_by_size(label, max_label: int):
    """Renumber the nonzero labels of [H, W] ``label`` to 1..K by descending
    pixel count, ties in label order; 0, and values outside [0, max_label),
    become 0. -> (renumbered int32 [H, W], K as an int32 tensor).

    The UCN path gives the max_instances crop slots to the largest clusters
    (ref: lib/fcn/test_dataset.py:314-321 crops every label, with no cap)."""
    flat, inside = _in_range(label, max_label)
    sizes = torch.bincount(flat[inside], minlength=max_label)
    sizes[0] = 0                                       # background takes no rank
    order = torch.argsort(-sizes, stable=True)
    new_id = torch.empty_like(order)
    new_id[order] = torch.arange(1, max_label + 1, device=label.device)
    new_id = torch.where(sizes > 0, new_id, 0)
    renumbered = torch.where(inside, new_id[flat], 0)
    return renumbered.reshape(label.shape).to(torch.int32), (sizes > 0).sum().to(torch.int32)
