"""Hungarian matcher: cost matrices on the device, assignment on the host.

Port of ``unseenobjectswithmeanshift_tpu.losses.matcher`` (ref:
MSMFormer/meanshiftformer/modeling/matcher.py). The cost of query q for gt g
is cost_mask * mean-BCE + cost_class * (-p(class)) + cost_dice * dice over one
uniform point set an image (:119-126), shared by every query and gt of that
image. The costs are computed batched in fp32 without gradient (the
reference's matcher runs under no_grad); ``solve_matches`` (``lsap.py``)
assigns them on the host.

Fixed shapes: gt padded to G slots with a contiguous validity mask (valid
slots first); each gt slot gets the index of its matched query, -1 where
invalid.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .lsap import solve_matches
from .point_sample import point_sample, point_sample_factored


def batch_dice_cost(inputs, targets):
    """[..., Q, P] logits x [..., G, P] binary -> [..., Q, G] (ref:
    batch_dice_loss, matcher.py:15-30)."""
    probs = inputs.sigmoid()
    numerator = 2 * torch.einsum("...qp,...gp->...qg", probs, targets)
    denominator = probs.sum(-1)[..., :, None] + targets.sum(-1)[..., None, :]
    return 1 - (numerator + 1) / (denominator + 1)


def batch_sigmoid_ce_cost(inputs, targets):
    """[..., Q, P] x [..., G, P] -> [..., Q, G] mean BCE with logits (ref:
    batch_sigmoid_ce_loss, matcher.py:38-62), by its pos/neg split."""
    P = inputs.shape[-1]
    pos = F.softplus(-inputs)
    neg = F.softplus(inputs)
    loss = (torch.einsum("...qp,...gp->...qg", pos, targets)
            + torch.einsum("...qp,...gp->...qg", neg, 1 - targets))
    return loss / P


@torch.no_grad()
def hungarian_cost_matrix(pred_logits, pred_masks, gt_labels, gt_masks, points,
                          cost_class: float = 2.0, cost_mask: float = 5.0,
                          cost_dice: float = 5.0, mask_embed=None, mask_features=None):
    """Cost matrices [B, Q, G]. pred_masks [B, Q, H, W], or None with the
    factored form mask_embed [B, Q, C] x mask_features [B, H, W, C];
    gt_masks [B, G, Hg, Wg]; points [B, P, 2], one uniform set an image."""
    B, Q = pred_logits.shape[:2]
    G = gt_labels.shape[1]
    out_prob = pred_logits.float().softmax(-1)                         # [B, Q, K+1]
    cost_cls = -torch.gather(out_prob, 2, gt_labels.long()[:, None, :].expand(B, Q, G))
    P = points.shape[1]
    if pred_masks is None:
        out_pts = point_sample_factored(mask_embed, mask_features, points)
    else:
        pts_q = points[:, None].expand(B, Q, P, 2).reshape(B * Q, P, 2)
        out_pts = point_sample(pred_masks.float().reshape(B * Q, *pred_masks.shape[2:]),
                               pts_q).reshape(B, Q, P)
    pts_g = points[:, None].expand(B, G, P, 2).reshape(B * G, P, 2)
    tgt_pts = point_sample(gt_masks.float().reshape(B * G, *gt_masks.shape[2:]),
                           pts_g).reshape(B, G, P)
    cm = batch_sigmoid_ce_cost(out_pts, tgt_pts)
    cd = batch_dice_cost(out_pts, tgt_pts)
    C = cost_mask * cm + cost_class * cost_cls + cost_dice * cd
    return torch.nan_to_num(C, nan=1e8, posinf=1e8, neginf=-1e8)


def assign(C, gt_valid):
    """Cost matrices C [..., B, Q, G] on the device (any leading dims, e.g.
    the deep-supervision heads) and gt_valid [B, G] -> (matched query per gt
    slot [..., B, G] int64 on C's device, -1 where invalid; the batch's
    valid gt count). One device-to-host copy of the costs and the counts."""
    counts = gt_valid.sum(-1).to(C.dtype)
    host = torch.cat([C.flatten(), counts]).cpu().numpy()
    n = C.numel()
    n_valid = host[n:].astype(int)
    matched = solve_matches(host[:n].reshape(C.shape),
                            np.broadcast_to(n_valid, C.shape[:-2]))
    return torch.from_numpy(matched).to(device=C.device, dtype=torch.long), int(n_valid.sum())


def hungarian_match(pred_logits, pred_masks, gt_labels, gt_masks, gt_valid, points,
                    cost_class: float = 2.0, cost_mask: float = 5.0,
                    cost_dice: float = 5.0, mask_embed=None, mask_features=None):
    """Matched query per gt slot [B, G] int64 on the inputs' device (-1
    where invalid)."""
    C = hungarian_cost_matrix(pred_logits, pred_masks, gt_labels, gt_masks, points,
                              cost_class, cost_mask, cost_dice, mask_embed, mask_features)
    return assign(C, gt_valid)[0]
