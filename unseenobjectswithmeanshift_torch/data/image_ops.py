"""The image operations of the training readers, with cv2's semantics and
without cv2.

The JAX reader crops and augments TOD samples with cv2 (JAX
``data/augmentation.py:42-98``, ``data/datasets.py:148-154``); the card
machine has no cv2. Each function here returns what the cv2 call returns
(cv2 5.0, held bit for bit by tests/test_torch_augmentation.py):

- ``resize_linear_u8``: ``cv2.resize`` INTER_LINEAR on uint8: float source
  positions ``(i + 0.5) * scale - 0.5``, 11-bit fixed-point coefficients
  (rounded half to even), the horizontal border taps reset to one source
  pixel, then the vertical step as cv2's vector code rounds it,
  ``((((S0 >> 4) * b0) >> 16) + (((S1 >> 4) * b1) >> 16) + 2) >> 2`` (its
  scalar ``(S0 b0 + S1 b1 + 2^21) >> 22`` differs by one on ~10% of the
  pixels, and cv2 does not take it at these widths);
- ``resize_nearest``: INTER_NEAREST, source index ``floor(i / scale)``
  (numpy gather, one implementation);
- ``resize_cubic_f64``: INTER_CUBIC on float64: float coefficients
  (A = -0.75), taps clamped to the edge, double sums left to right;
- ``bgr_to_hls_u8`` / ``hls_to_bgr_u8``: ``cv2.cvtColor`` COLOR_BGR2HLS /
  COLOR_HLS2BGR (hue 0-180) in float32 as cv2's vector code computes them
  (the hue one fused multiply-add, the saturation over 2 - (max + min));
  equal on all 2^24 BGR triples;
- ``filter_line_u8``: ``cv2.filter2D(img, -1, k / size)`` for the motion-
  blur kernels (ones on the middle row or column): float32 sums of fused
  multiply-adds in the kernel's order, BORDER_REFLECT_101, rounded half to
  even;
- ``ellipse_mask``: the pixels ``cv2.ellipse(..., thickness=-1)`` fills at
  integer centre, axes and angle: ellipse2Poly's polygon (cv2's table of
  sines to 7 decimals) in 16-bit fixed point, its outline drawn by Line2
  with clipLine, then FillConvexPoly's scanlines.

``backend="native"`` runs the host library (``native/uoms_native.cpp``,
ctypes, the interpreter lock released); ``backend="numpy"`` is its twin,
in numpy (the ellipse in plain Python integers).
"""

from __future__ import annotations

import math

import numpy as np

from .. import native

F32 = np.float32
XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
# cv2's SinTable: sin of whole degrees 0..450, to 7 decimals, as float
SIN_TABLE = np.array([round(math.sin(math.radians(k)), 7) for k in range(451)], np.float32)


def _source(dst: int, src: int):
    """cv2.resize's source position of each output index: (floor int64,
    float32 fraction)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(F32)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(F32)).astype(F32)


def _round(x):
    """cvRound of float32 values (half to even) as int64."""
    return np.rint(np.asarray(x, np.float64)).astype(np.int64)


def resize_linear_u8(img, dh: int, dw: int, backend: str = "native") -> np.ndarray:
    """cv2.resize(img, (dw, dh)) of uint8 [H, W] or [H, W, C]."""
    native.check_backend(backend)
    img = np.asarray(img, np.uint8)
    if backend == "native":
        return native.resize_linear_u8(img, dh, dw)
    H, W = img.shape[:2]
    sx, fx = _source(dw, W)
    edge = (sx < 0) | (sx >= W - 1)
    fx = np.where(edge, F32(0), fx)
    sx = np.clip(sx, 0, W - 1)
    a0, a1 = _round((F32(1) - fx) * F32(2048)), _round(fx * F32(2048))
    im = img.astype(np.int64).reshape(H, W, -1)
    rows = im[:, sx] * a0[None, :, None] + im[:, np.minimum(sx + 1, W - 1)] * a1[None, :, None]
    sy, fy = _source(dh, H)
    b0, b1 = _round((F32(1) - fy) * F32(2048)), _round(fy * F32(2048))
    s0, s1 = rows[np.clip(sy, 0, H - 1)], rows[np.clip(sy + 1, 0, H - 1)]
    v = (((s0 >> 4) * b0[:, None, None]) >> 16) + (((s1 >> 4) * b1[:, None, None]) >> 16)
    out = np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)
    return out.reshape((dh, dw) + img.shape[2:])


def resize_nearest(img, dh: int, dw: int) -> np.ndarray:
    """cv2.resize(img, (dw, dh), interpolation=INTER_NEAREST), any dtype."""
    H, W = img.shape[:2]
    sy = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / H))).astype(np.int64), H - 1)
    sx = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / W))).astype(np.int64), W - 1)
    return img[sy][:, sx]


def _cubic_taps(dst: int, src: int):
    s, x = _source(dst, src)
    one, A = F32(1), F32(-0.75)
    c0 = ((A * (x + one) - F32(5) * A) * (x + one) + F32(8) * A) * (x + one) - F32(4) * A
    c1 = ((A + F32(2)) * x - (A + F32(3))) * x * x + one
    c2 = ((A + F32(2)) * (one - x) - (A + F32(3))) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(s[:, None] + np.arange(-1, 3)[None], 0, src - 1)
    return idx, np.stack([c0, c1, c2, c3], -1).astype(F32).astype(np.float64)


def resize_cubic_f64(img, dh: int, dw: int, backend: str = "native") -> np.ndarray:
    """cv2.resize(img, (dw, dh), interpolation=INTER_CUBIC) of float64
    [H, W] or [H, W, C]."""
    native.check_backend(backend)
    img = np.asarray(img, np.float64)
    if backend == "native":
        return native.resize_cubic_f64(img, dh, dw)
    H, W = img.shape[:2]
    im = img.reshape(H, W, -1)
    ix, ax = _cubic_taps(dw, W)
    iy, ay = _cubic_taps(dh, H)
    t = im[:, ix]                                             # [H, dw, 4, C]
    h = (((t[:, :, 0] * ax[None, :, 0, None] + t[:, :, 1] * ax[None, :, 1, None])
          + t[:, :, 2] * ax[None, :, 2, None]) + t[:, :, 3] * ax[None, :, 3, None])
    r = h[iy]                                                 # [dh, 4, dw, C]
    out = (((r[:, 0] * ay[:, 0, None, None] + r[:, 1] * ay[:, 1, None, None])
            + r[:, 2] * ay[:, 2, None, None]) + r[:, 3] * ay[:, 3, None, None])
    return out.reshape((dh, dw) + img.shape[2:])


def bgr_to_hls_u8(img, backend: str = "native") -> np.ndarray:
    """cv2.cvtColor(img, COLOR_BGR2HLS) of uint8 [..., 3]."""
    native.check_backend(backend)
    if backend == "native":
        return native.bgr_to_hls_u8(img)
    x = np.asarray(img, np.uint8).astype(F32) * F32(1.0 / 255.0)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    vmax, vmin = np.maximum(np.maximum(r, g), b), np.minimum(np.minimum(r, g), b)
    diff, msum = vmax - vmin, vmax + vmin
    light = msum * F32(0.5)
    ok = diff > np.finfo(F32).eps
    safe = np.where(ok, diff, F32(1))
    sat = np.where(light < F32(0.5), safe / np.where(ok, msum, F32(1)),
                   safe / np.where(ok, F32(2) - msum, F32(1))).astype(F32)
    d = (F32(60) / safe).astype(F32)
    num = np.where(vmax == r, g - b, np.where(vmax == g, b - r, r - g))
    off = np.where(vmax == r, np.where(num < 0, F32(360), F32(0)),
                   np.where(vmax == g, F32(120), F32(240)))
    # num * d is exact in float64 and the sum needs at most 51 bits: the
    # float32 rounding of the float64 result is the fused multiply-add
    hue = (num.astype(np.float64) * d + off).astype(F32)
    hue = np.where(ok, hue, F32(0)) * F32(0.5)
    sat = np.where(ok, sat, F32(0))
    out = np.stack([_round(hue), _round(light * F32(255)), _round(sat * F32(255))], -1)
    return np.clip(out, 0, 255).astype(np.uint8)


SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hls_to_bgr_u8(img, backend: str = "native") -> np.ndarray:
    """cv2.cvtColor(img, COLOR_HLS2BGR) of uint8 [..., 3] (hue 0-180; values
    past 180 wrap as in cv2)."""
    native.check_backend(backend)
    if backend == "native":
        return native.hls_to_bgr_u8(img)
    img = np.asarray(img, np.uint8)
    k = F32(1.0 / 255.0)
    hue = img[..., 0].astype(F32)
    light, sat = img[..., 1].astype(F32) * k, img[..., 2].astype(F32) * k
    p2 = np.where(light <= F32(0.5), light * (F32(1) + sat), light + sat - light * sat).astype(F32)
    p1 = (F32(2) * light - p2).astype(F32)
    hue = (hue * F32(6.0 / 180.0)).astype(F32)
    hue = np.where(hue >= F32(6), hue - F32(6), hue).astype(F32)
    sector = np.floor(hue).astype(np.int64)
    frac = (hue - sector.astype(F32)).astype(F32)
    tab = np.stack([p2, p1, p1 + (p2 - p1) * (F32(1) - frac), p1 + (p2 - p1) * frac], -1)
    bgr = np.take_along_axis(tab.astype(F32), SECTORS[np.minimum(sector, 5)], -1)
    bgr = np.where((sat == 0)[..., None], light[..., None], bgr)
    return np.clip(_round(bgr * F32(255)), 0, 255).astype(np.uint8)


def _reflect101(i, n):
    i = np.abs(i)
    return np.where(i >= n, 2 * (n - 1) - i, i)


def filter_line_u8(img, size: int, horizontal: bool, backend: str = "native") -> np.ndarray:
    """cv2.filter2D(img, -1, k / size) of uint8 [H, W(, C)] where k is a
    size x size kernel of ones on its middle row (horizontal) or column."""
    native.check_backend(backend)
    img = np.asarray(img, np.uint8)
    if backend == "native":
        return native.filter_line_u8(img, size, horizontal)
    H, W = img.shape[:2]
    f = float(F32(1.0 / size))
    acc = np.zeros(img.shape, F32)
    for t in range(size):
        off = t - (size - 1) // 2
        src = (img[:, _reflect101(np.arange(W) + off, W)] if horizontal
               else img[_reflect101(np.arange(H) + off, H)])
        acc = (src.astype(np.float64) * f + acc).astype(F32)   # exact product: one FMA
    return np.clip(_round(acc), 0, 255).astype(np.uint8)


def ellipse_mask(shape, center, axes, angle: int, backend: str = "native") -> np.ndarray:
    """bool [H, W]: the pixels cv2.ellipse(np.zeros(shape), center, axes,
    angle, 0, 360, 1, thickness=-1) sets."""
    native.check_backend(backend)
    if backend == "native":
        mask = np.zeros(shape, np.uint8)
        native.ellipse_fill(mask, center, axes, angle, SIN_TABLE)
        return mask.astype(bool)
    return _Ellipse(shape).fill(center, axes, angle)


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


class _Ellipse:
    """cv2's ellipse2Poly, clipLine, Line2 and FillConvexPoly on a bool
    canvas, in Python integers (the native function's twin)."""

    def __init__(self, shape):
        self.mask = np.zeros(shape, bool)
        self.h, self.w = shape

    def put(self, x, y):
        if 0 <= x < self.w and 0 <= y < self.h:
            self.mask[y, x] = True

    def clip(self, x1, y1, x2, y2):
        right, bottom = (self.w << XY_SHIFT) - 1, (self.h << XY_SHIFT) - 1
        c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
        c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1 & 12:
                a = 0 if c1 < 8 else bottom
                x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
                y1, c1 = a, (x1 < 0) + (x1 > right) * 2
            if c2 & 12:
                a = 0 if c2 < 8 else bottom
                x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
                y2, c2 = a, (x2 < 0) + (x2 > right) * 2
            if (c1 & c2) == 0 and (c1 | c2) != 0:
                if c1:
                    a = 0 if c1 == 1 else right
                    y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                    x1, c1 = a, 0
                if c2:
                    a = 0 if c2 == 1 else right
                    y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                    x2, c2 = a, 0
        return (c1 | c2) == 0, x1, y1, x2, y2

    def line(self, x1, y1, x2, y2):
        ok, x1, y1, x2, y2 = self.clip(x1, y1, x2, y2)
        if not ok:
            return
        dx, dy = x2 - x1, y2 - y1
        flat = abs(dx) > abs(dy)
        if (dx < 0) if flat else (dy < 0):
            x1, x2, y1, y2 = x2, x1, y2, y1
        if flat:
            step, count = _cdiv((y2 - y1) * XY_ONE, abs(dx) | 1), (x2 - x1) >> XY_SHIFT
        else:
            step, count = _cdiv((x2 - x1) * XY_ONE, abs(dy) | 1), (y2 - y1) >> XY_SHIFT
        x1, y1 = x1 + (XY_ONE >> 1), y1 + (XY_ONE >> 1)
        self.put((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)
        if flat:
            x1 >>= XY_SHIFT
            for _ in range(count + 1):
                self.put(x1, y1 >> XY_SHIFT)
                x1, y1 = x1 + 1, y1 + step
        else:
            y1 >>= XY_SHIFT
            for _ in range(count + 1):
                self.put(x1 >> XY_SHIFT, y1)
                x1, y1 = x1 + step, y1 + 1

    def fill(self, center, axes, angle):
        cx, cy = int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT
        aw, ah = abs(int(axes[0])) << XY_SHIFT, abs(int(axes[1])) << XY_SHIFT
        delta = (max(aw, ah) + (XY_ONE >> 1)) >> XY_SHIFT
        delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
        angle = int(angle)
        while angle < 0:
            angle += 360
        while angle > 360:
            angle -= 360
        alpha, beta = float(SIN_TABLE[450 - angle]), float(SIN_TABLE[angle])
        v = []
        for i in range(0, 360 + delta, delta):
            a = min(i, 360)
            x, y = aw * float(SIN_TABLE[450 - a]), ah * float(SIN_TABLE[a])
            px, py = cx + x * alpha - y * beta, cy + x * beta + y * alpha
            qx = int(np.rint(px / XY_ONE)) << XY_SHIFT
            qy = int(np.rint(py / XY_ONE)) << XY_SHIFT
            pt = (qx + int(np.rint(px - qx)), qy + int(np.rint(py - qy)))
            if not v or v[-1] != pt:
                v.append(pt)
        if len(v) == 1:
            v = [(cx, cy)] * 2
        self.convex(v)
        return self.mask

    def convex(self, v):
        n, half = len(v), XY_ONE >> 1
        ys = [p[1] for p in v]
        imin = int(np.argmin(ys))
        prev = v[-1]
        for p in v:
            self.line(prev[0], prev[1], p[0], p[1])
            prev = p
        xmin = (min(p[0] for p in v) + half) >> XY_SHIFT
        xmax = (max(p[0] for p in v) + half) >> XY_SHIFT
        ymin, ymax = (min(ys) + half) >> XY_SHIFT, (max(ys) + half) >> XY_SHIFT
        if n < 3 or xmax < 0 or ymax < 0 or xmin >= self.w or ymin >= self.h:
            return
        ymax = min(ymax, self.h - 1)
        edge = [{"idx": imin, "di": 1, "x": -XY_ONE, "dx": 0, "ye": ymin},
                {"idx": imin, "di": n - 1, "x": -XY_ONE, "dx": 0, "ye": ymin}]
        edges, y = n, ymin
        while True:
            for e in edge:
                if y < e["ye"]:
                    continue
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % n
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + half) >> XY_SHIFT
                    if ty > y:
                        e.update(ye=ty, x=v[idx0][0], idx=idx,
                                 dx=_cdiv((v[idx][0] - v[idx0][0]) * 2 + (ty - y), 2 * (ty - y)))
                        break
                    idx0, idx = idx, (idx + e["di"]) % n
            if edges < 0:
                break
            if y >= 0:
                left, right = sorted((edge[0]["x"], edge[1]["x"]))
                x1, x2 = (left + half) >> XY_SHIFT, (right + half) >> XY_SHIFT
                if x2 >= 0 and x1 < self.w:
                    self.mask[y, max(x1, 0):min(x2, self.w - 1) + 1] = True
            edge[0]["x"] += edge[0]["dx"]
            edge[1]["x"] += edge[1]["dx"]
            y += 1
            if y > ymax:
                break
