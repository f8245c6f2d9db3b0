"""The port's native host library (``uoms_native.cpp``), built with g++ and
loaded with ctypes.

The source is the port's own copy of the JAX package's
``native/uoms_native.cpp``. It is compiled at first use into
``build/native/libuoms_native_<hash>.so`` under the repository root (the hash
covers the source and the flags, as ``ops/_build.py`` keys the CUDA
libraries), never beside the source. Nothing falls back: the readers and
the metric always call it, and a failed build raises with g++'s output. The
plain twins in ``utils/evaluation.py``, ``data/pcd.py`` and
``utils/image_io.py`` (``backend="numpy"`` of the functions there) are what
the tests hold it against. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "uoms_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
BACKENDS = ("native", "numpy")

_lib = None
build_seconds = None      # wall seconds of this process's build, None if reused


def check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    return backend


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libuoms_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists. Raises RuntimeError on failure."""
    global build_seconds
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    start = time.perf_counter()
    proc = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name} (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    build_seconds = time.perf_counter() - start
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library, building it if needed."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C")
    c = ctypes
    lib.boundary_overlap_counts.argtypes = [u8, u8, c.c_int, c.c_int, c.c_int, i64]
    lib.boundary_overlap_counts.restype = None
    ids = [i32, c.c_int, c.c_int64, c.c_int64]       # ids, count, their min and max
    lib.pairwise_mask_stats.argtypes = [i32, i32, c.c_int, *ids, *ids, i64, i64, i64]
    lib.pairwise_mask_stats.restype = c.c_int
    lib.pairwise_boundary_counts.argtypes = [i32, i32, c.c_int, c.c_int, *ids, *ids,
                                             c.c_int, i64, i64, i64]
    lib.pairwise_boundary_counts.restype = c.c_int
    lib.lzf_decompress.argtypes = [u8, c.c_int64, u8, c.c_int64]
    lib.lzf_decompress.restype = c.c_int64
    lib.png_unfilter.argtypes = [u8, c.c_int64, c.c_int64, c.c_int, u8]
    lib.png_unfilter.restype = c.c_int64
    _lib = lib
    return _lib


def boundary_overlap_counts(pred_mask, gt_mask, bound_pix: int):
    """(precision_tp, recall_tp) of one mask pair (JAX evaluation.boundary_overlap)."""
    if pred_mask.shape != gt_mask.shape or pred_mask.ndim != 2:
        raise ValueError(f"two masks of one [H, W] shape, got {pred_mask.shape} and "
                         f"{gt_mask.shape}")
    h, w = pred_mask.shape
    out = np.zeros(2, np.int64)
    get_lib().boundary_overlap_counts(
        np.ascontiguousarray(pred_mask, dtype=bool).view(np.uint8),
        np.ascontiguousarray(gt_mask, dtype=bool).view(np.uint8), h, w, int(bound_pix), out)
    return int(out[0]), int(out[1])


def _ids(ids):
    """(distinct ids int32, count, min, max): the native label map spans
    [min, max]."""
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    lo, hi = (int(ids.min()), int(ids.max())) if ids.size else (0, 0)
    return ids, ids.size, lo, hi


def _label_args(pred, gt, gt_ids, pred_ids):
    if pred.shape != gt.shape or pred.ndim != 2:
        raise ValueError(f"two label images of one [H, W] shape, got {pred.shape} and "
                         f"{gt.shape}")
    p32 = np.ascontiguousarray(pred, dtype=np.int32)
    g32 = np.ascontiguousarray(gt, dtype=np.int32)
    return p32, g32, _ids(gt_ids), _ids(pred_ids)


def pairwise_mask_stats(pred, gt, gt_ids, pred_ids):
    """One pass: (inter [ng, np], gt_sizes [ng], pred_sizes [np]) int64."""
    p32, g32, gids, pids = _label_args(pred, gt, gt_ids, pred_ids)
    ng, npred = gids[1], pids[1]
    inter = np.zeros((ng, npred), np.int64)
    gt_sizes = np.zeros(ng, np.int64)
    pred_sizes = np.zeros(npred, np.int64)
    if get_lib().pairwise_mask_stats(p32.reshape(-1), g32.reshape(-1), p32.size, *gids,
                                     *pids, inter, gt_sizes, pred_sizes) != 0:
        raise MemoryError(f"pairwise_mask_stats could not allocate label maps over "
                          f"{gids[2:]} and {pids[2:]}")
    return inter, gt_sizes, pred_sizes


def pairwise_boundary_counts(pred, gt, gt_ids, pred_ids, bound_pix: int):
    """(counts [ng, np, 2] int64 = boundary_overlap of each label pair,
    gt boundary sizes [ng], pred boundary sizes [np])."""
    p32, g32, gids, pids = _label_args(pred, gt, gt_ids, pred_ids)
    h, w = p32.shape
    ng, npred = gids[1], pids[1]
    counts = np.zeros((ng, npred, 2), np.int64)
    gb = np.zeros(ng, np.int64)
    pb = np.zeros(npred, np.int64)
    if get_lib().pairwise_boundary_counts(p32, g32, h, w, *gids, *pids, int(bound_pix),
                                          counts, gb, pb) != 0:
        raise MemoryError(f"pairwise_boundary_counts could not allocate its label maps "
                          f"over {gids[2:]} and {pids[2:]} or its dilation map")
    return counts, gb, pb


def lzf_decompress(data: bytes, expected: int) -> bytes:
    """LZF decompression (PCL's binary_compressed codec). Raises ValueError
    on a malformed stream."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty(expected, np.uint8)
    n = get_lib().lzf_decompress(np.ascontiguousarray(src), len(data), out, expected)
    if n < 0:
        raise ValueError("malformed LZF stream (a back reference before the output start, "
                         "or a truncated reference)")
    return out[:n].tobytes()


def png_unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """[h, stride] uint8 rows reconstructed from h filtered rows (a filter
    type byte each). Raises ValueError on an unknown filter type."""
    src = np.frombuffer(data, np.uint8)
    if bpp < 1 or src.size < h * (stride + 1):
        raise ValueError(f"{src.size} filtered bytes for {h} rows of {stride} (+1) bytes, "
                         f"bpp {bpp}")
    out = np.empty((h, stride), np.uint8)
    r = get_lib().png_unfilter(np.ascontiguousarray(src), h, stride, bpp, out)
    if r < 0:
        row = -r - 1
        raise ValueError(f"PNG row {row} has unknown filter type {src[row * (stride + 1)]}")
    return out
