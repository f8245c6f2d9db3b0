"""DETR-style set criterion: Hungarian-matched class CE + point-sampled mask losses.

Port of ``unseenobjectswithmeanshift_tpu.losses.criterion`` (ref:
MSMFormer/meanshiftformer/modeling/criterion.py):

- ``loss_labels`` (:122-138): weighted CE over all queries; unmatched
  queries get the no-object class with weight eos_coef; the weighted mean of
  torch's F.cross_entropy (divided by the sum of the weights).
- ``loss_masks`` (:140-190): importance-sampled points (oversample 3.0, top
  75% uncertain + 25% random), sigmoid CE averaged per point and summed over
  masks, dice with +1 smoothing, both divided by num_masks = max(#valid gts,
  1).
- Deep supervision (:239-245): every aux output is matched and scored the
  same way.

Masks are scored in factored form when the outputs carry ``mask_features``
[B, H, W, C] and a head its ``mask_embed`` [B, Q, C]: only the G matched
pairs' maps are materialized (me_g x mask_features), never the [B, Q, H, W]
per-layer maps. Pair compaction (``pair_budget``) then samples only that
many pairs, valid ones first; the gt sample window is built once and shared
by every head.

Every random draw is an argument (``CriterionDraws``): the matcher's uniform
points of each head and the importance-sampling candidates and fresh points
of each head, drawn for all B*G pair slots so that compaction does not
change them. ``draw`` makes them from a ``torch.Generator``; the CPU tests
pass the JAX package's own draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Union

import torch
import torch.nn.functional as F

from .matcher import assign, hungarian_cost_matrix
from .point_sample import (
    build_sample_window, draw_point_coords, get_uncertain_point_coords_with_randomness,
    point_sample,
)


@dataclass
class CriterionDraws:
    """Per head (the final output first, then each aux output): the matcher's
    points [B, num_points, 2], and the importance sampling's candidates
    [B*G, num_sampled, 2] and fresh points [B*G, num_random, 2]."""

    match_points: List[torch.Tensor]
    coords: List[torch.Tensor]
    rand: List[torch.Tensor]

    def to(self, device) -> "CriterionDraws":
        return CriterionDraws(*([t.to(device) for t in ts]
                                for ts in (self.match_points, self.coords, self.rand)))


def loss_labels(pred_logits, gt_labels, gt_valid, matched_query, num_classes: int,
                eos_coef: float):
    """Weighted cross entropy over all queries (ref: criterion.py:122-138)."""
    B, Q, _ = pred_logits.shape
    target = torch.full((B, Q), num_classes, dtype=torch.long, device=pred_logits.device)
    # scatter the matched gts' labels; invalid slots go to a dropped column Q
    q = torch.where(gt_valid, matched_query, Q)
    tgt = torch.cat([target, target[:, :1]], 1)
    tgt.scatter_(1, q, torch.where(gt_valid, gt_labels.long(), num_classes))
    target = tgt[:, :Q]
    logp = F.log_softmax(pred_logits.float(), dim=-1)
    nll = -torch.gather(logp, 2, target[..., None])[..., 0]
    weights = torch.where(target == num_classes, eos_coef, 1.0)
    return (nll * weights).sum() / weights.sum()


def sigmoid_ce_loss(point_logits, point_labels, pair_valid, num_masks):
    """[M, P] -> scalar: per-mask mean BCE summed over masks / num_masks
    (ref: criterion.py:48-70)."""
    bce = F.softplus(point_logits) - point_logits * point_labels
    return (bce.mean(-1) * pair_valid).sum() / num_masks


def dice_loss(point_logits, point_labels, pair_valid, num_masks):
    """(ref: criterion.py:21-45)"""
    probs = point_logits.sigmoid()
    numerator = 2 * (probs * point_labels).sum(-1)
    denominator = probs.sum(-1) + point_labels.sum(-1)
    loss = (1 - (numerator + 1) / (denominator + 1)) * pair_valid
    return loss.sum() / num_masks


def loss_masks(pred_masks, gt_masks, gt_valid, matched_query, num_masks, num_points: int,
               oversample_ratio: float, importance_sample_ratio: float, coords, rand,
               mask_embed=None, mask_features=None, pair_idx=None, tgt_win=None,
               pair_valid_c=None, sample_dtype=None):
    """Point-sampled mask losses over the matched pairs (ref:
    criterion.py:140-190). Predicted masks materialized (pred_masks
    [B, Q, H, W]) or factored (mask_embed [B, Q, C], mask_features
    [B, H, W, C]); gt_masks [B, G, Hg, Wg]; matched_query [B, G]. pair_idx
    [P]: sample only these flattened b*G+g slots (pair compaction); tgt_win /
    pair_valid_c: their gt window and validity. sample_dtype: the dtype the
    maps are sampled in (bf16: the reference's AMP autocast)."""
    factored = pred_masks is None
    B, Q = (mask_embed.shape[:2] if factored else pred_masks.shape[:2])
    G, Hg, Wg = gt_masks.shape[1:]
    mq = matched_query.clamp(0, Q - 1)
    if factored:
        me_g = torch.gather(mask_embed, 1, mq[..., None].expand(-1, -1, mask_embed.shape[2]))
        _, H, W, Cm = mask_features.shape
        mfT = mask_features.reshape(B, H * W, Cm).transpose(1, 2).float()
        src = torch.bmm(me_g.float(), mfT).reshape(B * G, H, W)
    else:
        src = torch.gather(pred_masks, 1, mq[..., None, None].expand(
            -1, -1, *pred_masks.shape[2:]))
        src = src.reshape(B * G, *src.shape[2:]).float()
    if pair_idx is not None:
        src = src[pair_idx]
        pair_valid = pair_valid_c
    else:
        pair_valid = gt_valid.reshape(B * G).float()
    if sample_dtype is not None:
        src = src.to(sample_dtype)
    with torch.no_grad():
        points = get_uncertain_point_coords_with_randomness(
            src.detach(), num_points, oversample_ratio, importance_sample_ratio,
            coords, rand, row_idx=pair_idx)
        if tgt_win is None:
            tgt = gt_masks.reshape(B * G, Hg, Wg)
            if pair_idx is not None:
                tgt = tgt[pair_idx]
            tgt_win = build_sample_window(tgt, sample_dtype or torch.float32)
        point_labels = point_sample(None, points, win=tgt_win)
    point_logits = point_sample(src, points)
    return {"loss_mask": sigmoid_ce_loss(point_logits, point_labels, pair_valid, num_masks),
            "loss_dice": dice_loss(point_logits, point_labels, pair_valid, num_masks)}


class SetCriterion:
    """Functional criterion; call with model outputs, padded targets and
    the step's draws."""

    def __init__(self, num_classes: int = 2, class_weight: float = 2.0,
                 mask_weight: float = 5.0, dice_weight: float = 5.0, eos_coef: float = 0.1,
                 num_points: int = 12544, oversample_ratio: float = 3.0,
                 importance_sample_ratio: float = 0.75, deep_supervision: bool = True,
                 sample_dtype: Optional[torch.dtype] = None):
        self.num_classes = num_classes
        self.class_weight, self.mask_weight, self.dice_weight = (
            class_weight, mask_weight, dice_weight)
        self.eos_coef = eos_coef
        self.num_points = num_points
        self.oversample_ratio = oversample_ratio
        self.importance_sample_ratio = importance_sample_ratio
        self.deep_supervision = deep_supervision
        self.sample_dtype = sample_dtype

    def weight_dict(self):
        return {"loss_ce": self.class_weight, "loss_mask": self.mask_weight,
                "loss_dice": self.dice_weight}

    def heads(self, outputs: Dict) -> List[Dict]:
        heads = [outputs]
        if self.deep_supervision and "aux_outputs" in outputs:
            heads = heads + list(outputs["aux_outputs"])
        return heads

    def draw(self, n_heads: int, B: int, G: int, generator: torch.Generator,
             device) -> CriterionDraws:
        """Every draw of one call, from ``generator``."""
        pts, coords, rand = [], [], []
        for _ in range(n_heads):
            pts.append(torch.rand(B, self.num_points, 2, generator=generator, device=device))
            c, r = draw_point_coords(B * G, self.num_points, self.oversample_ratio,
                                     self.importance_sample_ratio, generator, device)
            coords.append(c)
            rand.append(r)
        return CriterionDraws(pts, coords, rand)

    def __call__(self, outputs: Dict, gt_labels, gt_masks, gt_valid, draws: CriterionDraws,
                 pair_budget: Union[None, int, Callable[[int], int]] = None):
        """outputs: pred_logits [B, Q, K+1], mask_embed (with mask_features)
        or pred_masks, aux_outputs; gt_labels [B, G]; gt_masks [B, G, H, W];
        gt_valid [B, G] bool, valid slots first. pair_budget: sample only
        that many pairs (>= the valid count, else valid pairs drop out of the
        mask losses), or a function of the batch's valid count that gives it
        (``train.trainer.pair_bucket``). Returns (total loss, dict of the raw
        losses). One device-to-host copy: the cost matrices of every head
        and the gt counts, for the assignment (and the count for a
        pair_budget function)."""
        num_masks = gt_valid.sum().float().clamp_min(1.0)
        heads = self.heads(outputs)
        B, G = gt_valid.shape
        Hg, Wg = gt_masks.shape[2:]
        mask_features = outputs.get("mask_features")
        factored = [mask_features is not None and "mask_embed" in h for h in heads]
        Cs = torch.stack([hungarian_cost_matrix(
            h["pred_logits"], None if f else h["pred_masks"], gt_labels, gt_masks,
            draws.match_points[i], self.class_weight, self.mask_weight, self.dice_weight,
            mask_embed=h.get("mask_embed") if f else None,
            mask_features=mask_features if f else None)
            for i, (h, f) in enumerate(zip(heads, factored))])
        matched_all, n_valid = assign(Cs, gt_valid)

        # pair compaction and the gt sample window, built once for every head
        if callable(pair_budget):
            pair_budget = pair_budget(n_valid)
        valid_flat = gt_valid.reshape(B * G)
        tgt = gt_masks.reshape(B * G, Hg, Wg)
        if pair_budget is not None and pair_budget < B * G:
            # a stable argsort puts the valid slots first, in their order
            order = torch.argsort((~valid_flat).to(torch.int8), stable=True)
            pair_idx = order[:pair_budget]
            pair_valid_c = valid_flat[pair_idx].float()
            tgt = tgt[pair_idx]
        else:
            pair_idx = pair_valid_c = None
        tgt_win = build_sample_window(tgt, self.sample_dtype)

        losses, total = {}, 0.0
        for i, (head, f) in enumerate(zip(heads, factored)):
            matched = matched_all[i]
            l_ce = loss_labels(head["pred_logits"], gt_labels, gt_valid, matched,
                               self.num_classes, self.eos_coef)
            lm = loss_masks(None if f else head["pred_masks"], gt_masks, gt_valid, matched,
                            num_masks, self.num_points, self.oversample_ratio,
                            self.importance_sample_ratio, draws.coords[i], draws.rand[i],
                            mask_embed=head.get("mask_embed") if f else None,
                            mask_features=mask_features if f else None, pair_idx=pair_idx,
                            tgt_win=tgt_win, pair_valid_c=pair_valid_c,
                            sample_dtype=self.sample_dtype)
            suffix = "" if i == 0 else f"_{i - 1}"
            losses[f"loss_ce{suffix}"] = l_ce
            losses[f"loss_mask{suffix}"] = lm["loss_mask"]
            losses[f"loss_dice{suffix}"] = lm["loss_dice"]
            total = total + self.class_weight * l_ce + self.mask_weight * lm["loss_mask"] \
                + self.dice_weight * lm["loss_dice"]
        return total, losses
