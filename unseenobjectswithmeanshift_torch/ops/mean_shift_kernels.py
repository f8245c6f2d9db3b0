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

X is [B, N, d] fp32 (unit rows), d in EMBED_DIMS (64, or 128 for the 'cat'
fusion's embedding), first_seed_idx an int or a [B] integer tensor, read as
the JAX package's ``X[first_seed_idx]`` reads it (``ops.mean_shift.first_row``)
and returned as given in indices[:, 0].
"""

from __future__ import annotations

import ctypes

import torch

from .mean_shift import assign_clusters, connected_components, fps_batched, seed_hill_climbing

EMBED_DIMS = (64, 128)  # the widths D the .cu files are instantiated for
EMBED_DIM = 64          # the default width (cfg.backbone.num_units)
MAX_SEEDS = 1024       # MAX_SEEDS in mean_shift_climb.cu
CLIMB_BLOCK_SEEDS = 128  # BLOCK_SEEDS in mean_shift_climb.cu: seeds a block at d = 64
FPS_THREADS = 512       # THREADS in fps_seeds.cu: a row takes d / 4 lanes (one float4 each)
FPS_ROWS_PER_PASS = 32  # rows a block of fps_seeds.cu takes per pass at d = 64
FPS_REG_ROWS = 16       # REG in fps_seeds.cu: register rows a lane group holds
FPS_RED_FLOATS = 36     # RED_FLOATS in fps_seeds.cu: the argmax scratch
FPS_L2_BYTES = 24 << 20  # rows of X the FPS grid keeps in the L2 across steps, at most
CLIMB_TILE = 64         # keys per tile (TK in mean_shift_climb.cu)
# what a climbing block costs beyond its tiles (its seeds' split, its
# partial), in tile times: ~3 from scripts/sweep_mean_shift_blocks.py (one
# wave of 37-tile blocks against two of 19 at B=1, PERF.md)
CLIMB_BLOCK_TILES = 3

_libs: dict = {}
_limits: dict = {}


def _library(name: str):
    from . import _build

    if name not in _libs:
        lib = _build.load(name)
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "fps_seeds":
            lib.uoms_fps_seeds.argtypes = [p] * 7 + [i] * 11 + [p]
            lib.uoms_fps_seeds.restype = i
            lib.uoms_fps_device_limits.argtypes = [p]
            lib.uoms_fps_device_limits.restype = i
            lib.uoms_fps_error_string.argtypes = [i]
            lib.uoms_fps_error_string.restype = ctypes.c_char_p
        else:
            lib.uoms_ms_climb.argtypes = [p] * 3 + [i] * 4 + [ctypes.c_float, i, i, p]
            lib.uoms_ms_climb.restype = i
            lib.uoms_climb_error_string.argtypes = [i]
            lib.uoms_climb_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def device_limits(device) -> dict:
    """What the launch plans need of a CUDA device, read by the FPS library:
    SM count, the most dynamic shared memory a block may opt in to, and
    cooperative-launch support. Raises if the device has no cooperative launch
    (the FPS kernel needs every block resident)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _limits:
        lib = _library("fps_seeds")
        out = (ctypes.c_int * 5)()
        with torch.cuda.device(index):
            rc = lib.uoms_fps_device_limits(ctypes.addressof(out))
        if rc != 0:
            raise RuntimeError(f"cannot read the limits of CUDA device {index}: CUDA error {rc} "
                               f"({lib.uoms_fps_error_string(rc).decode()})")
        if not out[2]:
            raise RuntimeError(f"CUDA device {index} has no cooperative launch, which the "
                               "FPS kernel needs")
        if (out[3], out[4]) != (FPS_THREADS, FPS_REG_ROWS):
            raise RuntimeError("fps_seeds.cu and ops/mean_shift_kernels.py disagree on the "
                               "block shape")
        _limits[index] = {"sms": out[0], "smem_per_block": out[1]}
    return _limits[index]


def fps_rows_per_pass(d: int) -> int:
    """Rows a block of fps_seeds.cu takes per pass at width d (d / 4 lanes a
    row): 32 at d = 64, 16 at d = 128."""
    return FPS_THREADS * 4 // d


def _fps_launch_plan(B: int, N: int, sms: int, smem_per_block: int, d: int):
    """The plan of one launch over all B images (fps_plan), or None when the
    running distances of a slice do not fit in shared memory."""
    total = B * N
    rows = -(-total // min(sms, total))
    grid = -(-total // rows)
    image_slots = (rows - 1 + N - 1) // N + 1
    row_bytes = 4 * d
    fixed = 4 * (image_slots * d + FPS_RED_FLOATS + -(-rows // 4) * 4)
    if fixed > smem_per_block:
        return None
    resident = min(rows, (smem_per_block - fixed) // row_bytes)
    register = FPS_REG_ROWS if rows > resident else 0
    on_chip = min(rows, resident + register * fps_rows_per_pass(d))
    l2 = min(rows - on_chip, FPS_L2_BYTES // (grid * row_bytes))
    slices = [rows] * (grid - 1) + [total - (grid - 1) * rows]
    off_chip = [max(0, n - on_chip) for n in slices]
    return {"grid": grid, "rows_per_block": rows, "resident_rows": resident,
            "register_rows": register, "l2_rows": l2, "image_slots": image_slots,
            "smem_bytes": fixed + row_bytes * resident,
            "l2_held_rows": sum(min(n, l2) for n in off_chip),
            "streamed_rows": sum(max(0, n - l2) for n in off_chip)}


def fps_plan(B: int, N: int, sms: int, smem_per_block: int, d: int = 64) -> dict:
    """Launch plan of the persistent FPS kernel (csrc/fps_seeds.cu) for X
    [B, N, d] on a device with `sms` SMs and `smem_per_block` bytes of
    dynamic shared memory a block may opt in to. At d = 128 a row takes
    twice the bytes and a pass half the rows, so a block holds half as many
    rows on chip.

    A launch cuts the rows of its images into one range of `grid` equal
    slices of `rows_per_block` rows (the last may be shorter), one block per
    SM (the plan fills a block's shared memory, so one block fits an SM, and
    all are resident). A slice keeps, for all S steps: the running distance
    of every row and the first `resident_rows` rows of X in shared memory,
    the next `register_rows` rows per lane group (0, or FPS_REG_ROWS) in
    registers, and the next `l2_rows` rows in the L2 (FPS_L2_BYTES over the
    grid); the rest of the slice is read from device memory at every step.
    `image_slots` is the most images a slice can touch.

    Each image's chain is its own, so when the running distances of a slice
    of all B images do not fit in shared memory, the images are cut into
    `groups` of whole images, as few and as even as fit, each launched alone
    (the seeds are the same bits). -> dict: `groups`, the (first, end) image
    range of each launch; the keys above and `smem_bytes` (the kernel's
    dynamic shared memory, as fps_smem_bytes in the .cu file computes it) of
    the first group's launch (``fps_plan(end - first, N, ...)`` plans each
    group); and, over all launches, the rows kept in the L2
    (`l2_held_rows`) and read from device memory at every step
    (`streamed_rows`). Raises ValueError when one image does not fit."""
    if d not in EMBED_DIMS:
        raise ValueError(f"the FPS kernel takes d in {EMBED_DIMS}, got {d}")
    if B < 1 or N < 1 or sms < 1:
        raise ValueError(f"need B, N, sms >= 1, got {B}, {N}, {sms}")
    if B * N > 2**31 - 1:
        raise ValueError(f"B * N = {B * N} rows: the FPS kernel takes fewer than 2^31")
    per_launch = B
    while _fps_launch_plan(per_launch, N, sms, smem_per_block, d) is None:
        if per_launch == 1:
            raise ValueError(f"one image of {N} rows: the running distances of a slice "
                             f"do not fit in {smem_per_block} bytes of shared memory")
        per_launch -= 1
    n_groups = -(-B // per_launch)
    sizes = [B // n_groups + (i < B % n_groups) for i in range(n_groups)]   # largest first
    ends = [sum(sizes[:i + 1]) for i in range(n_groups)]
    groups = list(zip([0] + ends[:-1], ends))
    plans = [_fps_launch_plan(e - b, N, sms, smem_per_block, d) for b, e in groups]
    return {**plans[0], "groups": groups,
            "l2_held_rows": sum(p["l2_held_rows"] for p in plans),
            "streamed_rows": sum(p["streamed_rows"] for p in plans)}


def climb_plan(B: int, N: int, sms: int, seed_blocks: int = 1) -> dict:
    """Launch plan of the hill-climbing kernel (csrc/mean_shift_climb.cu),
    one block per SM at a time: the key splits per image (keys per split a
    multiple of the 64-key tile) that take the least time, counted as waves
    of `sms` blocks times the tile times of a block (its tiles plus
    CLIMB_BLOCK_TILES), the fewest blocks on ties. seed_blocks: blocks per
    split and image (one per 128 seeds at d = 64, one per 64 at d = 128).
    -> dict with keys keys_per_block and nsplit."""
    best = None
    Bb = B * seed_blocks
    for per_image in range(1, max(1, 4 * sms // Bb) + 1):
        keys = -(-N // per_image)
        keys = -(-keys // CLIMB_TILE) * CLIMB_TILE
        nsplit = -(-N // keys)
        cost = -(-Bb * nsplit // sms) * (keys // CLIMB_TILE + CLIMB_BLOCK_TILES)
        if best is None or cost < best[0]:
            best = (cost, keys, nsplit)
    return {"keys_per_block": best[1], "nsplit": best[2]}


def _check_X(X):
    if X.device.type != "cuda":
        raise ValueError(f"X must be a CUDA tensor, got {X.device}")
    if X.dtype != torch.float32:
        raise TypeError(f"X must be torch.float32, got {X.dtype}")
    if X.dim() != 3 or X.shape[2] not in EMBED_DIMS or X.shape[0] < 1 or X.shape[1] < 1:
        raise ValueError(f"X must be [B, N, d] with d in {EMBED_DIMS} and B, N >= 1, "
                         f"got {tuple(X.shape)}")
    if not X.is_contiguous():
        raise ValueError("X must be contiguous")
    if X.data_ptr() % 16:
        raise ValueError("X must start on a 16-byte boundary (the kernels read float4)")


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
    """Farthest-point seeds: kernel on CUDA tensors (one cooperative launch
    for the whole chain of every image of a group, ``fps_plan``'s groups:
    one group unless the images do not fit one launch), plain version on CPU
    tensors. Counts its kernel launches in ``fps_seeds.launches``."""
    if X.device.type == "cpu":
        return fps_seeds_plain(X, first_seed_idx, num_seeds)
    _check_X(X)
    if num_seeds < 1:
        raise ValueError(f"num_seeds must be >= 1, got {num_seeds}")
    B, N, d = X.shape
    first = _first_indices(first_seed_idx, B, X.device)
    limits = device_limits(X.device)
    seeds = torch.empty((B, num_seeds, d), dtype=torch.float32, device=X.device)
    indices = torch.empty((B, num_seeds), dtype=torch.int32, device=X.device)
    lib = _library("fps_seeds")
    stream = torch.cuda.current_stream(X.device).cuda_stream
    for b0, b1 in fps_plan(B, N, **limits, d=d)["groups"]:
        plan = fps_plan(b1 - b0, N, **limits, d=d)
        pv = torch.empty((2, plan["grid"] + b1 - b0), dtype=torch.float32, device=X.device)
        pi = torch.empty((2, plan["grid"] + b1 - b0), dtype=torch.int32, device=X.device)
        count = torch.empty(1, dtype=torch.int32, device=X.device)   # zeroed by the kernel's entry
        with torch.cuda.device(X.device):
            rc = lib.uoms_fps_seeds(X[b0:b1].data_ptr(), first[b0:b1].data_ptr(),
                                    seeds[b0:b1].data_ptr(), indices[b0:b1].data_ptr(),
                                    pv.data_ptr(), pi.data_ptr(), count.data_ptr(), b1 - b0, N,
                                    d, num_seeds, plan["grid"], plan["rows_per_block"],
                                    plan["resident_rows"], plan["register_rows"],
                                    plan["l2_rows"], plan["image_slots"], plan["smem_bytes"],
                                    stream)
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
    plan = climb_plan(B, N, device_limits(X.device)["sms"],
                      seed_blocks=-(-num_seeds // (CLIMB_BLOCK_SEEDS if d == 64 else 64)))
    partial = torch.empty((B, plan["nsplit"], num_seeds, d), dtype=torch.float32,
                          device=X.device)
    lib = _library("mean_shift_climb")
    stream = torch.cuda.current_stream(X.device).cuda_stream
    with torch.cuda.device(X.device):
        rc = lib.uoms_ms_climb(X.data_ptr(), seeds.data_ptr(), partial.data_ptr(), B, N, d,
                               num_seeds, float(kappa), max_iters, plan["keys_per_block"],
                               stream)
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
