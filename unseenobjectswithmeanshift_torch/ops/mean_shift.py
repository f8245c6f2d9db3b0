"""von Mises-Fisher mean-shift clustering on the unit hypersphere, plain PyTorch.

Port of ``unseenobjectswithmeanshift_tpu.ops.mean_shift`` (ref:
lib/utils/mean_shift.py), the clustering of the UCN inference path (ref:
lib/fcn/test_dataset.py:44-59), cosine metric only:

- farthest-point ("smart") seed selection, ``select_smart_seeds``
- seed hill climbing Z <- normalize(exp(kappa Z X^T) X), ``seed_hill_climbing``
- connected components of the seeds at cosine distance <= epsilon (the
  sweep on the CUDA kernel ``csrc/connected_components.cu`` for a CUDA
  tensor, the numpy sweep for a CPU one)
- assignment of every point to its closest seed, largest cluster relabeled 0

These are the plain versions the CUDA kernels of ``ops/mean_shift_kernels.py``
are held against. Tie-breaking follows the JAX package: argmax and argmin take
the first index, the mode of the labels in a component takes the smallest
label, and the largest cluster (first on ties) becomes 0. Every function takes
a leading batch dimension where the JAX package vmaps.
"""

from __future__ import annotations

import numpy as np
import torch


def _normalize(x, dim=-1, eps=1e-12):
    """x / max(|x|, eps), with |x| = sqrt(sum x^2) as the JAX package takes it."""
    return x / torch.sqrt((x * x).sum(dim, keepdim=True)).clamp_min(eps)


def cosine_distance(a, b):
    """0.5 * (1 - a.b) pairwise; a [..., n, d], b [..., m, d] -> [..., n, m]."""
    return 0.5 * (1.0 - a @ b.transpose(-1, -2))


def first_row(first_seed_idx, N: int):
    """The row that ``X[first_seed_idx]`` reads in the JAX package (jnp
    indexing): -N <= i < 0 wraps to i + N, below -N clamps to 0, N and above
    clamp to N - 1."""
    return torch.where(first_seed_idx < 0, first_seed_idx + N, first_seed_idx).clamp(0, N - 1)


def fps_batched(X, first_seed_idx, num_seeds: int):
    """Farthest-point seeds of every image. X [B, N, d]; first_seed_idx an int
    or a [B] integer tensor, read as ``first_row`` says and returned as given
    in indices[:, 0]. -> (seeds [B, S, d], indices [B, S] int32).

    The loop indexes with the argmax tensor, never with a host scalar, so it
    queues its work without a host sync on a CUDA tensor too."""
    B, N, _ = X.shape
    rows = torch.arange(B, device=X.device)
    first = torch.as_tensor(first_seed_idx, dtype=torch.int64, device=X.device).expand(B)
    idx = first_row(first, N)
    seeds, indices = [], []
    min_dist = None
    for i in range(num_seeds):
        if i > 0:
            idx = torch.argmax(min_dist, dim=1)            # ties: first index
        seed = X[rows, idx]                                # [B, d]
        seeds.append(seed)
        indices.append(first if i == 0 else idx)           # indices[0] as given
        if i == num_seeds - 1:
            break
        dist = 0.5 * (1.0 - torch.bmm(X, seed[:, :, None])[..., 0])
        min_dist = dist if min_dist is None else torch.minimum(min_dist, dist)
    return torch.stack(seeds, 1), torch.stack(indices, 1).to(torch.int32)


def select_smart_seeds(X, num_seeds: int, first_seed_idx):
    """Farthest-point seed selection (ref: mean_shift.py:128-189). X [n, d]
    unit vectors. -> (seeds [num_seeds, d], indices [num_seeds] int32)."""
    seeds, indices = fps_batched(X[None], first_seed_idx, num_seeds)
    return seeds[0], indices[0]


def seed_hill_climbing(X, Z, kappa: float, max_iters: int = 10):
    """Mean-shift hill climbing of seeds Z [..., S, d] on the vMF KDE of
    X [..., N, d] (ref: seed_hill_climbing_ball, mean_shift.py:79-109)."""
    Xt = X.transpose(-1, -2)
    for _ in range(max_iters):
        W = torch.exp(kappa * (Z @ Xt))                     # [..., S, N]
        Z = _normalize(W @ X, dim=-1)
    return Z


def _sweep(within: np.ndarray) -> np.ndarray:
    """The reference's sequential sweep over one image's [S, S] adjacency."""
    S = within.shape[0]
    labels = np.full(S, -1, np.int32)
    K = 0
    for i in range(S):
        if labels[i] != -1:
            continue
        component = within[i]
        member = labels[component]
        member = member[member >= 0]
        if member.size:
            labels[component] = np.bincount(member).argmax()   # ties: smallest
        else:
            labels[component] = K
            K += 1
    return labels


def seed_adjacency(Z, epsilon: float):
    """[..., S, S] uint8: 1 where two seeds lie within epsilon (cosine
    distance), computed on Z's device."""
    return (cosine_distance(Z, Z) <= epsilon).to(torch.uint8)


def connected_components_plain(within):
    """The numpy sweep over every [S, S] adjacency of ``within`` [..., S, S]
    (the kernel's plain twin). -> int32 labels [..., S] on within's device;
    a CUDA ``within`` is copied to the host once (one sync)."""
    w = within.cpu().numpy().astype(bool)
    flat = w.reshape(-1, *w.shape[-2:])
    labels = np.stack([_sweep(x) for x in flat]).reshape(w.shape[:-1])
    return torch.from_numpy(labels).to(within.device)


MAX_CC_SEEDS = 1024   # MAX_SEEDS in csrc/connected_components.cu
_cc_lib = None


def _cc_library():
    global _cc_lib
    if _cc_lib is None:
        import ctypes

        from . import _build

        lib = _build.load("connected_components")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.uoms_connected_components.argtypes = [p, p, i, i, p]
        lib.uoms_connected_components.restype = i
        lib.uoms_cc_error_string.argtypes = [i]
        lib.uoms_cc_error_string.restype = ctypes.c_char_p
        _cc_lib = lib
    return _cc_lib


def connected_components_sweep(within):
    """Labels of the sweep over ``within`` [B, S, S] uint8: the CUDA kernel
    (``csrc/connected_components.cu``, one block per image, no host sync) on
    a CUDA tensor, counted in ``connected_components_sweep.launches``; the
    numpy sweep on a CPU tensor. -> [B, S] int32."""
    if within.device.type == "cpu":
        return connected_components_plain(within)
    if within.dtype != torch.uint8 or within.dim() != 3 or within.shape[1] != within.shape[2]:
        raise ValueError(f"within must be [B, S, S] uint8, got {tuple(within.shape)} "
                         f"{within.dtype}")
    B, S, _ = within.shape
    if not 1 <= S <= MAX_CC_SEEDS or B < 1:
        raise ValueError(f"the connected-components kernel takes 1 <= S <= {MAX_CC_SEEDS} "
                         f"and B >= 1, got B={B}, S={S}")
    within = within.contiguous()
    labels = torch.empty((B, S), dtype=torch.int32, device=within.device)
    lib = _cc_library()
    with torch.cuda.device(within.device):
        rc = lib.uoms_connected_components(
            within.data_ptr(), labels.data_ptr(), B, S,
            torch.cuda.current_stream(within.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"connected_components kernel launch failed: CUDA error {rc} "
                           f"({lib.uoms_cc_error_string(rc).decode()})")
    connected_components_sweep.launches += 1
    return labels


connected_components_sweep.launches = 0


def connected_components(Z, epsilon: float):
    """Label seeds whose pairwise cosine distance <= epsilon into components
    (ref: connected_components, mean_shift.py:41-76): for each unlabeled seed
    i, the seeds within epsilon take the mode of their existing labels (ties
    to the smallest), or a new label if none has one.

    Z [..., S, d] -> int32 labels [..., S] in [0, S), on Z's device. The
    adjacency is computed on Z's device; the sweep runs on the kernel for a
    CUDA Z (no host sync) and in numpy for a CPU one."""
    within = seed_adjacency(Z, epsilon)
    lead = within.shape[:-2]
    S = within.shape[-1]
    return connected_components_sweep(within.reshape(-1, S, S)).reshape(*lead, S)


def assign_clusters(X, Z, seed_labels):
    """Each point takes the label of its closest seed (argmin of the cosine
    distance, first on ties); then the largest cluster is relabeled 0.
    X [B, N, d], Z [B, S, d], seed_labels [B, S] -> [B, N] int32."""
    S = Z.shape[1]
    closest = torch.argmin(cosine_distance(X, Z), dim=-1)     # [B, N]
    labels = torch.gather(seed_labels.long(), 1, closest)
    counts = torch.zeros(labels.shape[0], S, dtype=torch.int64, device=labels.device)
    counts.scatter_add_(1, labels, torch.ones_like(labels))
    label_max = torch.argmax(counts, dim=1, keepdim=True)      # ties: first
    swapped = torch.where(labels == 0, label_max,
                          torch.where(labels == label_max, 0, labels))
    return swapped.to(torch.int32)


def mean_shift_smart_init(X, kappa: float = 20.0, num_seeds: int = 100,
                          max_iters: int = 10, epsilon: float = 0.04,
                          first_seed_idx=0):
    """Full mean-shift clustering (ref: mean_shift_smart_init,
    mean_shift.py:192-229). X [n, d] unit vectors. -> (cluster_labels [n]
    int32 with the largest cluster relabeled 0, selected_indices [S])."""
    labels, indices = _smart_init_batched(X[None], kappa, num_seeds, max_iters,
                                          epsilon, first_seed_idx)
    return labels[0], indices[0]


def _smart_init_batched(X, kappa, num_seeds, max_iters, epsilon, first_seed_idx):
    seeds, indices = fps_batched(X, first_seed_idx, num_seeds)
    Z = seed_hill_climbing(X, seeds, kappa, max_iters)
    return assign_clusters(X, Z, connected_components(Z, epsilon)), indices


def clustering_features(features, num_seeds: int = 100, kappa: float = 20.0,
                        max_iters: int = 10, epsilon: float = 0.04,
                        first_seed_idx=0):
    """Cluster a batch of embedding maps into label images (ref:
    clustering_features, lib/fcn/test_dataset.py:44-59). features
    [B, H, W, C] L2-normalized. -> (labels [B, H, W] int32, indices [B, S])."""
    B, H, W, C = features.shape
    labels, indices = _smart_init_batched(features.reshape(B, H * W, C), kappa,
                                          num_seeds, max_iters, epsilon,
                                          first_seed_idx)
    return labels.reshape(B, H, W), indices
