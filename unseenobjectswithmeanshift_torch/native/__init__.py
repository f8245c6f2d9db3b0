"""The port's native host library (``uoms_native.cpp``), built with g++ and
loaded with ctypes (which releases the interpreter lock during each call).

The source is the port's own copy of the JAX package's
``native/uoms_native.cpp``. It is compiled at first use into
``build/native/libuoms_native_<hash>.so`` under the repository root (the hash
covers the source and the flags, as ``ops/_build.py`` keys the CUDA
libraries), never beside the source. Nothing falls back: the readers and
the metric always call it, and a failed build raises with g++'s output. The
plain twins in ``utils/evaluation.py``, ``data/pcd.py``, ``utils/image_io.py``,
``utils/jpeg.py`` and ``data/image_ops.py`` (``backend="numpy"`` of the
functions there) are what the tests hold it against. Nothing here runs at
import time.
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
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off"]
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
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C")
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C")
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C")
    lib.jpeg_header.argtypes = [u8, c.c_int64, i32, c.c_char_p, c.c_int]
    lib.jpeg_header.restype = c.c_int
    lib.jpeg_decode.argtypes = [u8, c.c_int64, c.c_int, u8, c.c_char_p, c.c_int]
    lib.jpeg_decode.restype = c.c_int
    hw = [c.c_int] * 3
    lib.resize_linear_u8.argtypes = [u8, *hw, u8, c.c_int, c.c_int]
    lib.resize_linear_u8.restype = None
    lib.resize_cubic_f64.argtypes = [f64, *hw, f64, c.c_int, c.c_int]
    lib.resize_cubic_f64.restype = None
    for name in ("bgr_to_hls_u8", "hls_to_bgr_u8"):
        getattr(lib, name).argtypes = [u8, c.c_int64, u8]
        getattr(lib, name).restype = None
    lib.filter_line_u8.argtypes = [u8, *hw, c.c_int, c.c_int, u8]
    lib.filter_line_u8.restype = None
    lib.ellipse_fill.argtypes = [u8, c.c_int, c.c_int, *[c.c_int] * 5, f32]
    lib.ellipse_fill.restype = None
    lib.telea_inpaint_u8c3.argtypes = [u8, u8, c.c_int, c.c_int, c.c_int, u8]
    lib.telea_inpaint_u8c3.restype = None
    lib.dilate_u8.argtypes = [u8, c.c_int, c.c_int, c.c_int, c.c_int, u8]
    lib.dilate_u8.restype = None
    lib.fill_poly_u8.argtypes = [u8, c.c_int, c.c_int, i32, c.c_int, c.c_uint8]
    lib.fill_poly_u8.restype = None
    lib.resize_cubic_f32.argtypes = [f32, *hw, f32, c.c_int, c.c_int]
    lib.resize_cubic_f32.restype = None
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


def jpeg_decode(data: bytes, channels: int = 3) -> np.ndarray:
    """A baseline JPEG file as cv2.imread gives it: [H, W, 3] BGR uint8
    (channels 3) or [H, W] luma (channels 1). Raises ValueError naming what
    the file holds that the decoder does not decode (progressive, lossless,
    arithmetic coding, 12-bit samples, 2 or 4 components) or what is corrupt."""
    lib = get_lib()
    src = np.frombuffer(data, np.uint8)
    info = np.zeros(3, np.int32)
    err = ctypes.create_string_buffer(256)
    if lib.jpeg_header(src, src.size, info, err, 256) != 0:
        raise ValueError(err.value.decode())
    h, w = int(info[0]), int(info[1])
    out = np.empty((h, w, channels) if channels == 3 else (h, w), np.uint8)
    if lib.jpeg_decode(src, src.size, channels, out, err, 256) != 0:
        raise ValueError(err.value.decode())
    return out


def _hwc(img, dtype, *out_hw):
    """(C-contiguous array, H, W, C) of an [H, W] or [H, W, C] image; raises
    on an empty image or output size."""
    a = np.ascontiguousarray(img, dtype=dtype)
    if a.ndim not in (2, 3) or 0 in a.shape or any(int(n) < 1 for n in out_hw):
        raise ValueError(f"an [H, W] or [H, W, C] image with no empty side and an output "
                         f"size of at least 1x1, got {a.shape} -> {out_hw}")
    return a, a.shape[0], a.shape[1], (a.shape[2] if a.ndim == 3 else 1)


def resize_linear_u8(img, dh: int, dw: int) -> np.ndarray:
    """cv2.resize(img, (dw, dh)) (INTER_LINEAR) of uint8 [H, W] or [H, W, C]."""
    a, h, w, c = _hwc(img, np.uint8, dh, dw)
    out = np.empty((dh, dw) + a.shape[2:], np.uint8)
    get_lib().resize_linear_u8(a, h, w, c, out, dh, dw)
    return out


def resize_cubic_f64(img, dh: int, dw: int) -> np.ndarray:
    """cv2.resize(img, (dw, dh), interpolation=INTER_CUBIC) of float64 [H, W(, C)]."""
    a, h, w, c = _hwc(img, np.float64, dh, dw)
    out = np.empty((dh, dw) + a.shape[2:], np.float64)
    get_lib().resize_cubic_f64(a, h, w, c, out, dh, dw)
    return out


def _pixels(img, fn):
    a = np.ascontiguousarray(img, dtype=np.uint8)
    if a.shape[-1] != 3:
        raise ValueError(f"three channels expected, got shape {a.shape}")
    out = np.empty_like(a)
    fn(a, a.size // 3, out)
    return out


def bgr_to_hls_u8(img) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_BGR2HLS) of uint8 [..., 3]."""
    return _pixels(img, get_lib().bgr_to_hls_u8)


def hls_to_bgr_u8(img) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_HLS2BGR) of uint8 [..., 3]."""
    return _pixels(img, get_lib().hls_to_bgr_u8)


def filter_line_u8(img, size: int, horizontal: bool) -> np.ndarray:
    """cv2.filter2D(img, -1, k / size) of uint8 [H, W(, C)], k a size x size
    kernel of ones on its middle row (horizontal) or middle column."""
    a, h, w, c = _hwc(img, np.uint8)
    if size < 1 or size % 2 == 0:
        raise ValueError(f"the line kernel's size must be odd and positive, got {size}")
    out = np.empty_like(a)
    get_lib().filter_line_u8(a, h, w, c, int(size), int(bool(horizontal)), out)
    return out


def ellipse_fill(mask: np.ndarray, center, axes, angle: int, sin_table: np.ndarray) -> None:
    """In place: mask (uint8 [H, W], C-contiguous) set to 1 where
    cv2.ellipse(mask, center, axes, angle, 0, 360, 1, -1) draws."""
    if mask.dtype != np.uint8 or mask.ndim != 2 or not mask.flags["C_CONTIGUOUS"]:
        raise ValueError("ellipse_fill draws into a C-contiguous uint8 [H, W] mask")
    if len(sin_table) != 451:
        raise ValueError(f"cv2's sine table has 451 entries, got {len(sin_table)}")
    get_lib().ellipse_fill(mask, mask.shape[0], mask.shape[1], int(center[0]), int(center[1]),
                           int(axes[0]), int(axes[1]), int(angle),
                           np.ascontiguousarray(sin_table, dtype=np.float32))


def telea_inpaint_u8c3(img, mask, radius: int) -> np.ndarray:
    """cv2.inpaint(img, mask, radius, INPAINT_TELEA) of uint8 [H, W, 3]."""
    a = np.ascontiguousarray(img, dtype=np.uint8)
    m = np.ascontiguousarray(np.asarray(mask) != 0, dtype=np.uint8)
    if a.ndim != 3 or a.shape[2] != 3 or min(a.shape[:2]) < 2 or m.shape != a.shape[:2]:
        raise ValueError(f"a uint8 [H, W, 3] image of at least 2x2 (cv2 reads outside a "
                         f"narrower one) and an [H, W] mask, got {a.shape} and {m.shape}")
    out = np.empty_like(a)
    get_lib().telea_inpaint_u8c3(a, m, a.shape[0], a.shape[1], int(radius), out)
    return out


def dilate_u8(img, kh: int, kw: int) -> np.ndarray:
    """cv2.dilate(img, np.ones((kh, kw))) of uint8 [H, W]."""
    a = np.ascontiguousarray(img, dtype=np.uint8)
    if a.ndim != 2 or 0 in a.shape or kh < 1 or kw < 1:
        raise ValueError(f"a uint8 [H, W] image and a kernel of at least 1x1, got {a.shape} "
                         f"and {kh}x{kw}")
    out = np.empty_like(a)
    get_lib().dilate_u8(a, a.shape[0], a.shape[1], int(kh), int(kw), out)
    return out


def fill_poly_u8(mask: np.ndarray, pts, value: int = 1) -> None:
    """In place: cv2.fillPoly(mask, [pts], value) of integer points [n, 2]
    (x, y) into a C-contiguous uint8 [H, W] mask."""
    if mask.dtype != np.uint8 or mask.ndim != 2 or not mask.flags["C_CONTIGUOUS"]:
        raise ValueError("fill_poly_u8 draws into a C-contiguous uint8 [H, W] mask")
    p = np.ascontiguousarray(pts, dtype=np.int32)
    if p.ndim != 2 or p.shape[1] != 2 or len(p) == 0 or 0 in mask.shape:
        raise ValueError(f"one or more (x, y) points [n, 2] and a non-empty mask, got points "
                         f"{p.shape} and mask {mask.shape}")
    if np.abs(p).max() >= 1 << 15 or not 0 <= int(value) <= 255:
        raise ValueError(f"polygon coordinates within +-32767 (16-bit fixed point) and a "
                         f"uint8 value, got |x|, |y| up to {np.abs(p).max()} and {value}")
    get_lib().fill_poly_u8(mask, mask.shape[0], mask.shape[1], p, len(p), int(value))


def resize_cubic_f32(img, dh: int, dw: int) -> np.ndarray:
    """cv2.resize(img, (dw, dh), interpolation=INTER_CUBIC) of float32
    [H, W(, C)], as cv2 computes it with IPP off."""
    a, h, w, c = _hwc(img, np.float32, dh, dw)
    out = np.empty((dh, dw) + a.shape[2:], np.float32)
    get_lib().resize_cubic_f32(a, h, w, c, out, dh, dw)
    return out
