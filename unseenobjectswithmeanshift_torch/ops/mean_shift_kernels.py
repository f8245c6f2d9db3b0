"""Farthest-point seeding and fused vMF hill climbing of the UCN clustering.

Port of ``unseenobjectswithmeanshift_tpu.ops.pallas_mean_shift`` with the same
function names without ``_pallas``:

- ``fps_seeds``: farthest-point seed selection, the CUDA kernel in
  ``csrc/fps_seeds.cu`` (replaces ``fps_seeds_pallas``);
- ``mean_shift_seeds``: the same seeding, then ``max_iters`` hill-climbing
  steps on the CUDA kernel in ``csrc/mean_shift_climb.cu`` (replaces
  ``mean_shift_seeds_pallas``);
- ``mean_shift_smart_init_fps`` / ``mean_shift_smart_init_fused``: the whole
  clustering with the seeds from one of the two.

On a CPU tensor every function runs the plain PyTorch version
(``ops/mean_shift.py``); on a CUDA tensor it launches the kernel or raises.
There is no other fallback. Each kernel wrapper counts its launches in
``.launches``.

X is [B, N, 64] fp32 (unit rows), first_seed_idx an int or a [B] integer
tensor, read as the JAX package's ``X[first_seed_idx]`` reads it
(``ops.mean_shift.first_row``) and returned as given in indices[:, 0].
"""

from __future__ import annotations

import ctypes

import torch

from .mean_shift import assign_clusters, connected_components, fps_batched, seed_hill_climbing

EMBED_DIM = 64         # D in the .cu files
MAX_SEEDS = 128        # MAX_SEEDS in mean_shift_climb.cu
# Blocks per step over the whole batch, at most: one wave on an H100 (132
# SMs) at 8 FPS blocks (full occupancy) or 2 climbing blocks per SM. Each
# image takes floor(target / B) of them, so that a batch never spills a few
# blocks into a second wave. scripts/sweep_mean_shift_blocks.py measures
# other targets.
FPS_BLOCKS = 1056
FPS_ROWS_ALIGN = 16    # rows per pass of an FPS block
CLIMB_BLOCKS = 264
CLIMB_TILE = 64        # keys per tile (TK in mean_shift_climb.cu)

_libs: dict = {}


def _library(name: str):
    from . import _build

    if name not in _libs:
        lib = _build.load(name)
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "fps_seeds":
            lib.uoms_fps_seeds.argtypes = [p] * 7 + [i] * 5 + [p]
            lib.uoms_fps_seeds.restype = i
            lib.uoms_fps_error_string.argtypes = [i]
            lib.uoms_fps_error_string.restype = ctypes.c_char_p
        else:
            lib.uoms_ms_climb.argtypes = [p] * 3 + [i] * 4 + [ctypes.c_float, i, i, p]
            lib.uoms_ms_climb.restype = i
            lib.uoms_climb_error_string.argtypes = [i]
            lib.uoms_climb_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def _check_X(X):
    if X.device.type != "cuda":
        raise ValueError(f"X must be a CUDA tensor, got {X.device}")
    if X.dtype != torch.float32:
        raise TypeError(f"X must be torch.float32, got {X.dtype}")
    if X.dim() != 3 or X.shape[2] != EMBED_DIM or X.shape[0] < 1 or X.shape[1] < 1:
        raise ValueError(f"X must be [B, N, {EMBED_DIM}] with B, N >= 1, got {tuple(X.shape)}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous")


def _first_indices(first_seed_idx, B: int, device) -> torch.Tensor:
    if isinstance(first_seed_idx, torch.Tensor):
        if first_seed_idx.shape not in ((), (B,)) or first_seed_idx.device != device:
            raise ValueError(f"first_seed_idx must be a scalar or [{B}] tensor on {device}")
        if first_seed_idx.dtype.is_floating_point or first_seed_idx.dtype == torch.bool:
            raise TypeError(f"first_seed_idx must be an integer tensor, got {first_seed_idx.dtype}")
        return first_seed_idx.to(torch.int32).expand(B).contiguous()
    return torch.full((B,), int(first_seed_idx), dtype=torch.int32, device=device)


# the kernel's plain twin: select_smart_seeds batched over B
fps_seeds_plain = fps_batched


def fps_seeds(X, first_seed_idx, num_seeds: int = 100):
    """Farthest-point seeds: kernel on CUDA tensors, plain version on CPU
    tensors. Counts its kernel launches in ``fps_seeds.launches``."""
    if X.device.type == "cpu":
        return fps_seeds_plain(X, first_seed_idx, num_seeds)
    _check_X(X)
    if num_seeds < 1:
        raise ValueError(f"num_seeds must be >= 1, got {num_seeds}")
    B, N, d = X.shape
    first = _first_indices(first_seed_idx, B, X.device)
    per_image = max(1, FPS_BLOCKS // B)
    rows = -(-N // per_image)
    rows = -(-rows // FPS_ROWS_ALIGN) * FPS_ROWS_ALIGN
    nblk = -(-N // rows)
    seeds = torch.empty((B, num_seeds, d), dtype=torch.float32, device=X.device)
    indices = torch.empty((B, num_seeds), dtype=torch.int32, device=X.device)
    dist = torch.empty((B, N), dtype=torch.float32, device=X.device)
    pv = torch.empty((2, B, nblk), dtype=torch.float32, device=X.device)
    pi = torch.empty((2, B, nblk), dtype=torch.int32, device=X.device)
    lib = _library("fps_seeds")
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = lib.uoms_fps_seeds(X.data_ptr(), first.data_ptr(), seeds.data_ptr(),
                            indices.data_ptr(), dist.data_ptr(), pv.data_ptr(),
                            pi.data_ptr(), B, N, d, num_seeds, rows, stream)
    if rc != 0:
        raise RuntimeError(f"fps_seeds kernel launch failed: CUDA error {rc} "
                           f"({lib.uoms_fps_error_string(rc).decode()})")
    fps_seeds.launches += 1
    return seeds, indices


fps_seeds.launches = 0


def mean_shift_seeds_plain(X, first_seed_idx, kappa: float = 20.0,
                           num_seeds: int = 100, max_iters: int = 10):
    """select_smart_seeds + seed_hill_climbing, batched over B.
    -> (updated seeds [B, S, d], indices [B, S] int32)."""
    seeds, indices = fps_seeds_plain(X, first_seed_idx, num_seeds)
    return seed_hill_climbing(X, seeds, kappa, max_iters), indices


def mean_shift_seeds(X, first_seed_idx, kappa: float = 20.0, num_seeds: int = 100,
                     max_iters: int = 10):
    """Seeding on the FPS kernel, then hill climbing on the climbing kernel
    (CUDA tensors), or the plain version (CPU tensors). Counts the climbing
    kernel's launches in ``mean_shift_seeds.launches`` (the seeding counts in
    ``fps_seeds.launches``)."""
    if X.device.type == "cpu":
        return mean_shift_seeds_plain(X, first_seed_idx, kappa, num_seeds, max_iters)
    _check_X(X)
    if not 1 <= num_seeds <= MAX_SEEDS:
        raise ValueError(f"the climbing kernel takes 1 <= num_seeds <= {MAX_SEEDS}, "
                         f"got {num_seeds}")
    if max_iters < 0:
        raise ValueError(f"max_iters must be >= 0, got {max_iters}")
    seeds, indices = fps_seeds(X, first_seed_idx, num_seeds)
    if max_iters == 0:
        return seeds, indices
    B, N, d = X.shape
    per_image = max(1, CLIMB_BLOCKS // B)
    keys = -(-N // per_image)
    keys = -(-keys // CLIMB_TILE) * CLIMB_TILE
    nsplit = -(-N // keys)
    partial = torch.empty((B, nsplit, num_seeds, d), dtype=torch.float32, device=X.device)
    lib = _library("mean_shift_climb")
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = lib.uoms_ms_climb(X.data_ptr(), seeds.data_ptr(), partial.data_ptr(), B, N, d,
                           num_seeds, float(kappa), max_iters, keys, stream)
    if rc != 0:
        raise RuntimeError(f"mean_shift_seeds kernel launch failed: CUDA error {rc} "
                           f"({lib.uoms_climb_error_string(rc).decode()})")
    mean_shift_seeds.launches += 1
    return seeds, indices


mean_shift_seeds.launches = 0


def mean_shift_smart_init_fps(X, kappa: float = 20.0, num_seeds: int = 100,
                              max_iters: int = 10, epsilon: float = 0.04,
                              first_seed_idx=0):
    """Clustering with the seeding on ``fps_seeds``; hill climbing is plain
    ``torch.matmul`` + ``exp``, as the JAX package leaves it to XLA.
    X [B, N, d]. -> (cluster_labels [B, N] int32, indices [B, S])."""
    seeds, indices = fps_seeds(X, first_seed_idx, num_seeds)
    Z = seed_hill_climbing(X, seeds, kappa, max_iters)
    return assign_clusters(X, Z, connected_components(Z, epsilon)), indices


def mean_shift_smart_init_fused(X, kappa: float = 20.0, num_seeds: int = 100,
                                max_iters: int = 10, epsilon: float = 0.04,
                                first_seed_idx=0):
    """Clustering with seeding and hill climbing on ``mean_shift_seeds``.
    X [B, N, d]. -> (cluster_labels [B, N] int32, indices [B, S])."""
    Z, indices = mean_shift_seeds(X, first_seed_idx, kappa, num_seeds, max_iters)
    return assign_clusters(X, Z, connected_components(Z, epsilon)), indices
