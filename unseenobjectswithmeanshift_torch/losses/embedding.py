"""Metric-learning embedding loss of the UCN backbone.

Port of ``unseenobjectswithmeanshift_tpu.losses.embedding`` (ref:
lib/networks/embedding.py, cosine metric):
- spherical cluster means (:23-54);
- intra-cluster hinge: (cosine distance)^2 of the pixels farther than alpha
  from their cluster's mean, weighted per cluster by its hard pixels
  (:81-117);
- inter-cluster hinge: (delta - pairwise distance)^2 over the pairs of
  cluster means (:119-128).

Fixed shape: k_max cluster slots; the label image holds {-1, 0..K-1} (-1 =
unlabeled, ignored). K_actual (the batch's largest label + 1) stays on the
device: no host sync.
"""

from __future__ import annotations

import torch


def _onehot(labels, k_max: int, dtype):
    return (labels[..., None] == torch.arange(k_max, device=labels.device)).to(dtype)


def compute_cluster_means(x, labels, k_max: int, normalize: bool = True):
    """x [B, H, W, C], labels [B, H, W] in {-1, 0..k_max-1} -> [B, K, C].
    Normalized in rsqrt form: an empty slot's mean stays exactly 0 (F.normalize
    of 0) with a finite gradient."""
    onehot = _onehot(labels, k_max, x.dtype)
    sums = torch.einsum("bhwk,bhwc->bkc", onehot, x)
    counts = onehot.sum((1, 2))[..., None]
    means = sums / (counts + 1e-10)
    if normalize:
        means = means * torch.rsqrt(means.square().sum(-1, keepdim=True) + 1e-24)
    return means


def embedding_loss(x, labels, k_max: int, alpha: float = 0.02, delta: float = 0.5,
                   lambda_intra: float = 1.0, lambda_inter: float = 1.0,
                   normalize: bool = True):
    """x [B, H, W, C] L2-normalized embeddings, labels [B, H, W] int ->
    (loss, intra, inter)."""
    B, K = x.shape[0], k_max
    k_actual = (labels.max() + 1).clamp_min(1).to(x.dtype)
    means = compute_cluster_means(x, labels, K, normalize)
    onehot = _onehot(labels, K, x.dtype)
    tiled = torch.einsum("bhwk,bkc->bhwc", onehot, means)
    labeled = (labels >= 0).to(x.dtype)
    intra_d = labeled * 0.5 * (1.0 - (x * tiled).sum(-1))

    # hard-negative mining and per-cluster weighting (:98-114)
    any_hard = ((intra_d - alpha) > 0).to(x.dtype).sum() > 0
    hard_f = (intra_d > alpha).to(x.dtype)
    n_k = torch.einsum("bhw,bhwk->bk", hard_f, onehot)
    weights = torch.einsum("bhwk,bk->bhw", onehot, n_k)
    weights = weights.clamp_min(50.0) * k_actual
    intra = (intra_d.square() / weights).sum() / B
    intra = torch.where(any_hard, intra, 0.0) * lambda_intra

    # inter-cluster over slots 0..K_actual-1 (empty slots in range are zero
    # vectors: distance 0.5, as the reference's F.normalize(0) gives)
    in_range = torch.arange(K, device=x.device, dtype=x.dtype)[None, :] < k_actual
    pair_valid = in_range[:, :, None] & in_range[:, None, :]
    pair_valid = pair_valid & ~torch.eye(K, dtype=torch.bool, device=x.device)[None]
    d = 0.5 * (1.0 - torch.einsum("bkc,blc->bkl", means, means))
    hinge = (delta - d).clamp_min(0.0) * pair_valid
    denom = (k_actual * (k_actual - 1) / 2).clamp_min(1.0) * B
    inter = hinge.square().sum() / denom
    inter = torch.where(k_actual > 1, inter, 0.0) * lambda_inter
    return intra + inter, intra, inter
