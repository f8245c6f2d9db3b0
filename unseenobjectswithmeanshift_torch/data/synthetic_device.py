"""Synthetic scenes rendered, augmented and batched on the card.

Port of ``unseenobjectswithmeanshift_tpu.data.synthetic_jax``: the host
samples each scene's packed parameters (``data/synthetic.sample_scene_params``,
a few ms), the device does the rest in one pass over the batch:

  ray-cast render -> depth noise and ellipse dropout -> XYZ -> low-frequency
  XYZ noise -> chromatic and gaussian RGB noise -> UCN normalization
  (-> SYN_CROP) -> instance masks

- ``render_scene_batch`` (:134-205): per-pixel closest hit over the plane,
  spheres, boxes and capped cylinders, all three primitive kinds evaluated
  for every slot and selected by kind, in the JAX package's fp32 formulas.
  Deterministic given the parameters, so it is held against the JAX
  renderer (tests/test_torch_train_data.py). The table's mottle is upsampled
  with jax.image.resize's bicubic (Keys a = -0.5, half-pixel centres,
  weights renormalized at the border), as a pair of weight matrices.
- ``augment_depth`` / ``augment_xyz`` / ``augment_rgb`` (:207-303): the JAX
  augmentations, drawing from a ``torch.Generator``. The JAX
  ``augment_depth`` draws the ellipse centres' rows and columns from one
  key, so they fall on the image diagonal; here the two are independent
  draws, as the reference's dropout intends.
- ``syn_crop`` (:310-375, ``crop_windows`` then ``crop_resize``): a
  square crop around one present object, padded
  by uniform(0.5, 1.0) of its side, resized to S x S (bilinear for the
  image, nearest for label and XYZ), by gathers rather than selector
  matmuls. Two JAX-side defects are not copied: the bilinear taps clamp to
  the crop window (cv2.resize of the cropped image), not to the whole image
  (:361); and a scene with no foreground crops the whole image (with no
  instance) instead of a garbage window (:328-330).
- ``instances`` (:377-395): the label image's ids -> compacted masks, valid
  slots first, and the renumbered label image.
- ``make_train_batch`` (:397-436) and ``SyntheticDeviceLoader`` (:438-515):
  deterministic in (seed, step): scene i of a split is seeded as in the JAX
  package, the augmentations by a generator seeded by (seed, step).

The batch has the trainer's keys: image (normalized BGR), xyz, gt_masks,
gt_labels, gt_valid, label_image.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from ..config import UCN_PIXEL_MEANS_BGR
from .synthetic import (
    KIND_BOX, KIND_CYLINDER, KIND_SPHERE, fov_intrinsics, sample_scene_params,
)

_INF = float("inf")


def _dot3(a, b):
    return (a * b).sum(-1)


def _mat3(x, R):
    """x [..., 3] times R [B, 3, 3] (x^T R per row), as explicit fp32 sums."""
    return x[..., 0:1] * R[:, None, 0] + x[..., 1:2] * R[:, None, 1] + x[..., 2:3] * R[:, None, 2]


def stack_scene_params(params_list: List[Dict[str, np.ndarray]], device) -> Dict:
    """Per-scene packed parameters -> batched tensors on ``device``."""
    return {k: torch.from_numpy(np.stack([p[k] for p in params_list])).to(device)
            for k in params_list[0]}


def _cubic(x):
    """Keys' cubic kernel, a = -0.5 (jax.image's)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def bicubic_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] weights of jax.image.resize(method="bicubic") along one
    axis (upsampling: half-pixel centres, out-of-range taps dropped and the
    rest renormalized)."""
    inv = np.float32(1.0 / (n_out / n_in))
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs()
    w = _cubic(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).T.contiguous()


def resize_bicubic(x, hw):
    """[B, h, w, C] -> [B, H, W, C], jax.image.resize's bicubic (rows first,
    then columns)."""
    _, h, w, _ = x.shape
    Ry = bicubic_matrix(h, hw[0], x.device)
    Rx = bicubic_matrix(w, hw[1], x.device)
    y = torch.einsum("ih,bhwc->biwc", Ry, x)
    return torch.einsum("jw,biwc->bijc", Rx, y)


def _ray_dirs(H, W, fx, fy, px, py, device):
    rows = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    cols = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    d = torch.stack([((cols - px) / fx).expand(H, W), ((rows - py) / fy).expand(H, W),
                     torch.ones(H, W, device=device)], -1)
    return d.reshape(-1, 3)                                       # [N, 3], dz = 1


def _isect_plane(d, p0, n):
    dn = _dot3(d[None], n[:, None])                               # [B, N]
    t = torch.where(dn.abs() > 1e-9, _dot3(p0, n)[:, None] / torch.where(dn == 0, 1.0, dn),
                    _INF)
    return torch.where(t > 1e-6, t, _INF)


def _isect_sphere(d, c, r):
    a = (d * d).sum(1)[None]
    b = _dot3(d[None], c[:, None])
    cc = (_dot3(c, c) - r * r)[:, None]
    disc = b * b - a * cc
    ok = disc > 0
    sq = torch.sqrt(torch.where(ok, disc, 0.0))
    t = (b - sq) / a
    return torch.where(ok & (t > 1e-6), t, _INF)


def _isect_box(d, center, R, half):
    o = _mat3(-center[:, None], R)                                # [B, 1, 3]
    dd = _mat3(d[None], R)                                        # [B, N, 3]
    safe = torch.where(dd.abs() < 1e-12, 1e-12, dd)
    t1 = (-half[:, None] - o) / safe
    t2 = (half[:, None] - o) / safe
    tmin = torch.minimum(t1, t2).amax(-1)
    tmax = torch.maximum(t1, t2).amin(-1)
    hit = (tmax >= tmin) & (tmax > 1e-6)
    t = torch.where(tmin > 1e-6, tmin, tmax)
    return torch.where(hit, t, _INF)


def _isect_cylinder(d, base, axis, r, h):
    d = d[None]
    base, axis, r, h = base[:, None], axis[:, None], r[:, None], h[:, None]
    da = _dot3(d, axis)
    d_ort = d - da[..., None] * axis
    o = -base
    o_ort = o - _dot3(o, axis)[..., None] * axis
    a = (d_ort * d_ort).sum(-1)
    b = _dot3(d_ort, o_ort)
    c = _dot3(o_ort, o_ort) - r * r
    disc = b * b - a * c
    ok = (disc > 0) & (a > 1e-12)
    sq = torch.sqrt(torch.where(ok, disc, 0.0))
    sa = torch.where(a > 1e-12, a, 1.0)
    t_side = torch.where(ok, (-b - sq) / sa, _INF)
    z_hit = torch.where(torch.isfinite(t_side), t_side * da - _dot3(base, axis), _INF)
    t_side = torch.where((t_side > 1e-6) & (z_hit >= 0) & (z_hit <= h), t_side, _INF)
    t_caps = torch.full_like(t_side, _INF)
    for p0c in (base, base + h[..., None] * axis):
        tc = torch.where(da.abs() > 1e-9, _dot3(p0c, axis) / torch.where(da == 0, 1.0, da), _INF)
        hitp = torch.where(torch.isfinite(tc)[..., None], tc[..., None] * d, 0.0) - p0c
        inside = (hitp * hitp).sum(-1) <= r * r
        t_caps = torch.minimum(t_caps, torch.where((tc > 1e-6) & torch.isfinite(tc) & inside,
                                                   tc, _INF))
    return torch.minimum(t_side, t_caps)


def render_scene_batch(params: Dict, H: int, W: int, fx: float, fy: float, px: float,
                       py: float):
    """Closest-hit render of stacked parameters ([B, ...] tensors) -> (rgb
    [B, H, W, 3] in [0, 1], depth [B, H, W] in meters (0 where nothing is
    hit), label [B, H, W] int32: the hit slot's instance id, 0 for the
    table and background)."""
    dev = params["kinds"].device
    d = _ray_dirs(H, W, fx, fy, px, py, dev)
    B, M = params["kinds"].shape
    N = H * W
    n = params["plane_n"]
    t_best = _isect_plane(d, params["plane_p0"], n)
    ids = torch.zeros(B, N, dtype=torch.int32, device=dev)
    normals = n[:, None].expand(B, N, 3)
    mottle = resize_bicubic(params["mottle"][..., None], (H, W))[..., 0]
    albedos = params["table_albedo"][:, None] * (0.8 + 0.4 * mottle.reshape(B, N, 1))
    for i in range(M):
        kind = params["kinds"][:, i][:, None]
        c = params["centers"][:, i]
        axis = params["axes"][:, i]
        R = params["rots"][:, i]
        dims = params["dims"][:, i]
        r = dims[:, 0]
        t_s = _isect_sphere(d, c, r.clamp_min(1e-4))
        t_b = _isect_box(d, c, R, dims.clamp_min(1e-4))
        t_c = _isect_cylinder(d, c, axis, r.clamp_min(1e-4), dims[:, 1].clamp_min(1e-4))
        t = torch.where(kind == KIND_SPHERE, t_s, torch.where(
            kind == KIND_BOX, t_b, torch.where(kind == KIND_CYLINDER, t_c, _INF)))
        p = torch.where(torch.isfinite(t)[..., None], t[..., None] * d[None], 0.0)
        pc = p - c[:, None]
        z = _dot3(pc, axis[:, None])
        side = pc - z[..., None] * axis[:, None]
        h1 = dims[:, 1:2]
        nm_c = torch.where(((z > 1e-4) & (z < h1 - 1e-4))[..., None], side,
                           torch.sign(z - h1 / 2)[..., None] * axis[:, None])
        local = _mat3(pc, R)
        ax = (local.abs() / dims.clamp_min(1e-4)[:, None]).argmax(-1)           # [B, N]
        Rt = R.transpose(1, 2)
        nm_b = (torch.sign(torch.gather(local, 2, ax[..., None]) + 1e-30)
                * torch.gather(Rt, 1, ax[..., None].expand(B, N, 3)))
        kb = kind[..., None]
        nm = torch.where(kb == KIND_SPHERE, pc, torch.where(kb == KIND_BOX, nm_b, nm_c))
        hit = t < t_best
        t_best = torch.where(hit, t, t_best)
        ids = torch.where(hit, params["ids"][:, i][:, None], ids)
        normals = torch.where(hit[..., None], nm, normals)
        albedos = torch.where(hit[..., None], params["albedos"][:, i][:, None], albedos)
    depth = torch.where(torch.isfinite(t_best), t_best, 0.0)
    nn_ = normals / torch.linalg.vector_norm(normals, dim=-1, keepdim=True).clamp_min(1e-9)
    lam = _dot3(nn_, params["light"][:, None]).abs()
    rgb = (albedos * (0.35 + 0.65 * lam)[..., None]).clamp(0.0, 1.0)
    return rgb.reshape(B, H, W, 3), depth.reshape(B, H, W), ids.reshape(B, H, W)


# ---------------------------------------------------------------------------
# augmentation (data/augmentation.py's parameters)


def _gamma(shape_k: float, scale: float, size, generator, device):
    alpha = torch.full(size, shape_k, dtype=torch.float32, device=device)
    return torch._standard_gamma(alpha, generator=generator) * scale


def ellipse_params(B: int, H: int, W: int, generator, max_ellipses: int = 20,
                   ellipse_mean: float = 10.0, gamma_shape: float = 5.0,
                   gamma_scale: float = 1.0, device="cuda"):
    """The dropout ellipses of B images: count [B] (Poisson(10) clamped to
    max_ellipses), centres cy, cx [B, E] (independent uniform draws), radii
    rx, ry [B, E] (gamma), angle [B, E]."""
    size = (B, max_ellipses)
    n = torch.poisson(torch.full((B,), ellipse_mean, device=device),
                      generator=generator).clamp_max(max_ellipses)
    cy = torch.rand(size, generator=generator, device=device) * (H - 1.0)
    cx = torch.rand(size, generator=generator, device=device) * (W - 1.0)
    rx = _gamma(gamma_shape, gamma_scale, size, generator, device)
    ry = _gamma(gamma_shape, gamma_scale, size, generator, device)
    ang = torch.rand(size, generator=generator, device=device) * (2 * math.pi)
    return n, cy, cx, rx, ry, ang


def augment_depth(depth, generator, max_ellipses: int = 20, gamma_shape: float = 1000.0,
                  gamma_scale: float = 0.001):
    """[B, H, W] -> multiplicative gamma noise, then random ellipses dropped
    to 0 (invalid) (ref: augmentation.py add_noise_to_depth,
    dropout_random_ellipses)."""
    B, H, W = depth.shape
    dev = depth.device
    depth = depth * _gamma(gamma_shape, gamma_scale, (B, 1, 1), generator, dev)
    n, cy, cx, rx, ry, ang = ellipse_params(B, H, W, generator, max_ellipses, device=dev)
    rows = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    cols = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    drop = torch.zeros(B, H, W, dtype=torch.bool, device=dev)
    for i in range(max_ellipses):
        dy = rows - cy[:, i, None, None]
        dx = cols - cx[:, i, None, None]
        ca, sa = torch.cos(ang[:, i])[:, None, None], torch.sin(ang[:, i])[:, None, None]
        u = ca * dx + sa * dy
        v = -sa * dx + ca * dy
        inside = ((u / rx[:, i, None, None].clamp_min(0.5)) ** 2
                  + (v / ry[:, i, None, None].clamp_min(0.5)) ** 2) <= 1.0
        drop |= inside & (i < n)[:, None, None]
    return torch.where(drop, 0.0, depth)


def augment_xyz(xyz, depth, generator, gp_rescale_factor: int = 4,
                gaussian_scale: float = 0.005):
    """Additive noise on a grid of 1/gp_rescale_factor the size, upsampled
    bicubic, where depth > 0 (ref: augmentation.py add_noise_to_xyz)."""
    B, H, W, C = xyz.shape
    small = (B, H // gp_rescale_factor, W // gp_rescale_factor, C)
    noise = torch.randn(small, generator=generator, device=xyz.device) * gaussian_scale
    return xyz + torch.where((depth > 0)[..., None], resize_bicubic(noise, (H, W)), 0.0)


def _rgb_to_hls(rgb):
    mx, mn = rgb.amax(-1), rgb.amin(-1)
    c = mx - mn
    l = (mx + mn) / 2
    s = torch.where(c > 0, c / (1.0 - (2 * l - 1).abs()).clamp_min(1e-6), 0.0)
    r, g, b = rgb.unbind(-1)
    safe_c = torch.where(c > 0, c, 1.0)
    h = torch.where(mx == r, torch.remainder((g - b) / safe_c, 6.0),
                    torch.where(mx == g, (b - r) / safe_c + 2.0, (r - g) / safe_c + 4.0))
    return torch.where(c > 0, h / 6.0, 0.0), l, s


def _hls_to_rgb(h, l, s):
    c = (1.0 - (2 * l - 1).abs()) * s
    hp = torch.remainder(h, 1.0) * 6.0
    x = c * (1.0 - (torch.remainder(hp, 2.0) - 1.0).abs())
    z = torch.zeros_like(c)
    idx = torch.remainder(torch.floor(hp).long(), 6)
    rgbs = torch.stack([torch.stack(t, -1) for t in (
        (c, x, z), (x, c, z), (z, c, x), (z, x, c), (x, z, c), (c, z, x))], 0)
    sel = torch.gather(rgbs, 0, idx[None, ..., None].expand(1, *idx.shape, 3))[0]
    return (sel + (l - c / 2)[..., None]).clamp(0.0, 1.0)


def augment_rgb(rgb, generator):
    """[B, H, W, 3] in [0, 1]: chromatic HLS jitter (+-0.05 hue, +-0.1
    lightness and saturation), then gaussian noise of sigma u1 u2 0.1, each
    skipped with probability 0.1 (ref: blob.py:74-129)."""
    B = rgb.shape[0]
    dev = rgb.device
    u = torch.rand(B, 7, generator=generator, device=dev)[:, :, None, None]
    h, l, s = _rgb_to_hls(rgb)
    jit = _hls_to_rgb(h + (u[:, 0] - 0.5) * 0.1, (l + (u[:, 1] - 0.5) * 0.2).clamp(0, 1),
                      (s + (u[:, 2] - 0.5) * 0.2).clamp(0, 1))
    rgb = torch.where(u[:, 3, ..., None] > 0.1, jit, rgb)
    noise = (u[:, 4] * u[:, 5] * 0.1) * torch.randn(rgb.shape[:3], generator=generator,
                                                    device=dev)
    noisy = (rgb + noise[..., None]).clamp(0.0, 1.0)
    return torch.where(u[:, 6, ..., None] > 0.1, noisy, rgb)


# ---------------------------------------------------------------------------
# batch assembly


def crop_windows(label, max_gt: int, u, min_padding: float = 0.5, max_padding: float = 1.0):
    """The SYN_CROP windows (y_lo, y_hi, x_lo, x_hi) [B] of a label batch
    [B, H, W]: a square around one uniformly chosen present object (u[:, 0]),
    padded by uniform(min_padding, max_padding) of its side (u[:, 1]; 25 px
    where that rounds to 0), clamped to the image. A scene with no object
    gets the whole image."""
    B, H, W = label.shape
    dev = label.device
    ids = torch.arange(1, max_gt + 1, device=dev)
    present = (label[:, None] == ids[None, :, None, None]).flatten(2).any(-1)   # [B, G]
    count = present.sum(1)
    k = torch.minimum((u[:, 0] * count).floor().long(), (count - 1).clamp_min(0))
    choice = (present.cumsum(1) == (k + 1)[:, None]) & present
    obj = choice.float().argmax(1) + 1
    has = count > 0
    fg = label == obj[:, None, None]
    ri = torch.arange(H, dtype=torch.float32, device=dev)
    ci = torch.arange(W, dtype=torch.float32, device=dev)
    rows, cols = fg.any(2), fg.any(1)
    y_min = torch.where(rows, ri, float(H)).amin(1)
    y_max = torch.where(rows, ri, -1.0).amax(1)
    x_min = torch.where(cols, ci, float(W)).amin(1)
    x_max = torch.where(cols, ci, -1.0).amax(1)
    cx, cy = (x_min + x_max) / 2, (y_min + y_max) / 2
    xd, yd = x_max - x_min, y_max - y_min
    wide = xd > yd
    y_min, y_max = torch.where(wide, cy - xd / 2, y_min), torch.where(wide, cy + xd / 2, y_max)
    x_min, x_max = torch.where(wide, x_min, cx - yd / 2), torch.where(wide, x_max, cx + yd / 2)
    pad = torch.round((x_max - x_min) * (min_padding + (max_padding - min_padding) * u[:, 1]))
    pad = torch.where(pad == 0, 25.0, pad)
    y_lo = torch.where(has, (y_min - pad).floor().clamp(0, H - 1), 0.0)
    y_hi = torch.where(has, (y_max + pad).ceil().clamp(0, H - 1), H - 1.0)
    x_lo = torch.where(has, (x_min - pad).floor().clamp(0, W - 1), 0.0)
    x_hi = torch.where(has, (x_max + pad).ceil().clamp(0, W - 1), W - 1.0)
    return y_lo, torch.maximum(y_hi, y_lo + 1), x_lo, torch.maximum(x_hi, x_lo + 1)


def crop_resize(image, xyz, label, windows, S: int):
    """Crop each image, xyz [B, H, W, 3] and label [B, H, W] to its window
    and resize to S x S: bilinear for the image with half-pixel centres and
    the taps clamped to the window (cv2.resize of the cropped image),
    nearest for xyz and label (cv2's floor(i * scale))."""
    B, H, W = label.shape
    dev = label.device
    i = torch.arange(S, dtype=torch.float32, device=dev)[None]

    def taps(lo, hi, size):
        lo, hi = lo[:, None], hi[:, None]
        span = hi - lo + 1.0
        c = torch.minimum(torch.maximum(lo + (i + 0.5) * span / S - 0.5, lo), hi)
        i0 = c.floor()
        near = lo + torch.minimum((i * span / S).floor(), span - 1)
        idx = lambda t: t.clamp(0, size - 1).long()             # noqa: E731
        return idx(i0), idx(torch.minimum(i0 + 1, hi)), c - i0, idx(near)

    y_lo, y_hi, x_lo, x_hi = windows
    y0, y1, wy, yn = taps(y_lo, y_hi, H)
    x0, x1, wx, xn = taps(x_lo, x_hi, W)
    b = torch.arange(B, device=dev)[:, None, None]
    at = lambda t, ys, xs: t[b, ys[:, :, None], xs[:, None, :]]      # noqa: E731
    wy, wx = wy[:, :, None, None], wx[:, None, :, None]
    img_c = ((1 - wy) * ((1 - wx) * at(image, y0, x0) + wx * at(image, y0, x1))
             + wy * ((1 - wx) * at(image, y1, x0) + wx * at(image, y1, x1)))
    return img_c, at(xyz, yn, xn), at(label, yn, xn)


def syn_crop(image, xyz, label, S: int, max_gt: int, generator, min_padding: float = 0.5,
             max_padding: float = 1.0):
    """SYN_CROP of a batch: image, xyz [B, H, W, 3], label [B, H, W] ->
    [B, S, S, ...] (crop_windows with two uniform draws an image, then
    crop_resize)."""
    u = torch.rand(label.shape[0], 2, generator=generator, device=label.device)
    windows = crop_windows(label, max_gt, u, min_padding, max_padding)
    return crop_resize(image, xyz, label, windows, S)


def instances(label, max_gt: int):
    """[B, H, W] label image -> (masks [B, G, H, W] fp32, labels [B, G]
    int32 (all 1, the object class), valid [B, G], the label image
    renumbered 1..n in slot order): ids without pixels are dropped and the
    rest compacted to the front in order (the JAX _instances_device)."""
    ids = torch.arange(1, max_gt + 1, device=label.device)
    masks = label[:, None] == ids[None, :, None, None]
    valid = masks.flatten(2).any(-1)
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    masks = torch.gather(masks, 1, order[..., None, None].expand_as(masks))
    valid = torch.gather(valid, 1, order)
    slot = torch.arange(1, max_gt + 1, device=label.device) * valid
    renum = (masks * slot[..., None, None]).sum(1).to(torch.int32)
    return (masks.float(), torch.ones(label.shape[0], max_gt, dtype=torch.int32,
                                      device=label.device), valid, renum)


def make_train_batch(generator, params, H: int, W: int, fx: float, fy: float, px: float,
                     py: float, max_gt: int = 24, augment: bool = True, syn_crop_size=None):
    """Render, augment, normalize (and with syn_crop_size, SYN_CROP to that
    size), extract the instances. Returns the trainer's batch dict."""
    rgb, depth, label = render_scene_batch(params, H, W, fx, fy, px, py)
    dev = rgb.device
    if augment:
        depth = augment_depth(depth, generator)
    rows = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    cols = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    xyz = torch.stack([(cols - px) * depth / fx, (rows - py) * depth / fy, depth], -1)
    if augment:
        xyz = augment_xyz(xyz, depth, generator)
        rgb = augment_rgb(rgb, generator)
    means = torch.tensor(UCN_PIXEL_MEANS_BGR, dtype=torch.float32, device=dev) / 255.0
    image = rgb.flip(-1) - means
    if syn_crop_size is not None:
        image, xyz, label = syn_crop(image, xyz, label, syn_crop_size, max_gt, generator)
    masks, labels, valid, renum = instances(label, max_gt)
    return {"image": image, "xyz": xyz, "gt_masks": masks, "gt_labels": labels,
            "gt_valid": valid, "label_image": renum}


SCENE_STYLES = {
    "r4": dict(p_stack=0.0, p_composite=0.0, touching=False, max_slots=None),
    "ocid": dict(p_stack=0.3, p_composite=0.25, touching=True),
}


class SyntheticDeviceLoader:
    """Endless batches: the host samples the scene parameters, the device
    does the rest. Deterministic in (seed, step). syn_crop: render whole
    scenes at render_hw and return crop_size^2 crops around one object each
    (the crop network's training mode). scene_style "ocid": denser clutter
    (5-14 objects, stacking, concave composites, touching objects)."""

    def __init__(self, batch_size: int, height: int = 480, width: int = 640, max_gt: int = 24,
                 max_objects: int = 9, min_objects: int = 3, image_set: str = "train",
                 seed: int = 0, augment: bool = True, scene_style: str = "r4",
                 syn_crop: bool = False, crop_size: int = 224, render_hw=(480, 640),
                 device="cuda"):
        if scene_style not in SCENE_STYLES:
            raise ValueError(f"unknown scene_style {scene_style!r} (r4 | ocid)")
        self.B, self.max_gt, self.augment, self.seed = batch_size, max_gt, augment, seed
        self.H, self.W = render_hw if syn_crop else (height, width)
        self.crop_size = crop_size if syn_crop else None
        self.max_objects, self.min_objects = max_objects, min_objects
        self.style = dict(SCENE_STYLES[scene_style])
        if scene_style == "ocid":
            self.max_objects, self.min_objects = max(max_objects, 14), max(min_objects, 5)
            self.style["max_slots"] = max(20, self.max_objects + 6)
        self.split_salt = {"train": 0, "test": 1 << 20}[image_set]
        self.intr = fov_intrinsics(self.W, self.H)
        self.device = torch.device(device)
        self.step = 0

    def params_for(self, indices):
        return stack_scene_params([sample_scene_params(
            np.random.RandomState((self.seed * 1_000_003 + self.split_salt + int(i))
                                  % (2 ** 31 - 1)),
            self.intr, max_objects=self.max_objects, min_objects=self.min_objects,
            height=self.H, width=self.W, **self.style) for i in indices], self.device)

    def batch_at(self, step: int) -> Dict:
        params = self.params_for(range(step * self.B, (step + 1) * self.B))
        g = torch.Generator(device=self.device).manual_seed(
            (self.seed << 20) ^ step ^ self.split_salt)
        i = self.intr
        return make_train_batch(g, params, self.H, self.W, float(i["fx"]), float(i["fy"]),
                                float(i["x_offset"]), float(i["y_offset"]),
                                max_gt=self.max_gt, augment=self.augment,
                                syn_crop_size=self.crop_size)

    def __iter__(self):
        while True:
            batch = self.batch_at(self.step)
            self.step += 1
            yield batch
