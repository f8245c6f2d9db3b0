"""Host-side data augmentation of the training readers, without cv2.

Port of ``unseenobjectswithmeanshift_tpu.data.augmentation`` (:32-99): the
same five functions, parameters and random draws in the same order, so that
one ``np.random.RandomState`` gives the JAX functions' outputs and leaves the
same state. Each cv2 call is the cv2-equal operation of
``data/image_ops.py`` (``backend="numpy"`` runs its numpy twin).

Depth-noise suite from DexNet (ref: lib/utils/augmentation.py:58-126):
- add_noise_to_depth: multiplicative gamma noise
- add_noise_to_xyz: GP additive noise approximated by low-res gaussian upsampled
  bicubically, applied where depth > 0
- dropout_random_ellipses: Poisson count of gamma-sized ellipses zeroed out

RGB augmentation (ref: lib/utils/blob.py:74-129):
- chromatic_transform: HLS jitter (+-0.05 hue, +-0.1 sat/luma)
- add_noise: gaussian (90%) or motion blur (10%)

Default parameters mirror data_loading_params (ref: lib/datasets/tabletop_object.py:23-55).
"""

from __future__ import annotations

import numpy as np

from . import image_ops

DEFAULT_PARAMS = {
    "gamma_shape": 1000.0,
    "gamma_scale": 0.001,
    "gaussian_scale": 0.005,
    "gp_rescale_factor": 4,
    "ellipse_dropout_mean": 10,
    "ellipse_gamma_shape": 5.0,
    "ellipse_gamma_scale": 1.0,
}


def add_noise_to_depth(depth_img, params=DEFAULT_PARAMS, rng=np.random):
    mult = rng.gamma(params["gamma_shape"], params["gamma_scale"])
    return depth_img * mult


def add_noise_to_xyz(xyz_img, depth_img, params=DEFAULT_PARAMS, rng=np.random,
                     backend="native"):
    xyz_img = xyz_img.copy()
    H, W, C = xyz_img.shape
    small = (np.array([H, W]) / params["gp_rescale_factor"]).astype(int)
    noise = rng.normal(0.0, params["gaussian_scale"], size=(small[0], small[1], C))
    noise = image_ops.resize_cubic_f64(noise, H, W, backend)
    # xyz[depth > 0, :] += noise[depth > 0, :] without the two boolean
    # gathers: the same float64 sums, each rounded once to float32
    np.add(xyz_img, noise, out=xyz_img, where=(depth_img > 0)[..., None], casting="same_kind")
    return xyz_img


def dropout_random_ellipses(depth_img, params=DEFAULT_PARAMS, rng=np.random,
                            backend="native"):
    depth_img = depth_img.copy()
    n = rng.poisson(params["ellipse_dropout_mean"])
    nz = np.array(np.where(depth_img > 0)).T
    if len(nz) == 0 or n == 0:
        return depth_img
    centers = nz[rng.choice(nz.shape[0], size=n)]
    xr = rng.gamma(params["ellipse_gamma_shape"], params["ellipse_gamma_scale"], size=n)
    yr = rng.gamma(params["ellipse_gamma_shape"], params["ellipse_gamma_scale"], size=n)
    angles = rng.randint(0, 360, size=n)
    for i in range(n):
        mask = image_ops.ellipse_mask(depth_img.shape, centers[i][::-1],
                                      (int(np.round(xr[i])), int(np.round(yr[i]))),
                                      int(angles[i]), backend)
        depth_img[mask] = 0
    return depth_img


def chromatic_transform(im_bgr_u8, rng=np.random, backend="native"):
    """HLS jitter of a BGR uint8 image (ref: blob.py:74-99)."""
    d_h = (rng.rand(1) - 0.5) * 0.1 * 180
    d_l = (rng.rand(1) - 0.5) * 0.2 * 256
    d_s = (rng.rand(1) - 0.5) * 0.2 * 256
    hls = image_ops.bgr_to_hls_u8(im_bgr_u8, backend)
    h, l, s = hls[..., 0], hls[..., 1], hls[..., 2]
    new_h = (h + d_h) % 180
    new_l = np.clip(l + d_l, 0, 255)
    new_s = np.clip(s + d_s, 0, 255)
    new_hls = np.stack((new_h, new_l, new_s), -1).astype("uint8")
    return image_ops.hls_to_bgr_u8(new_hls, backend)


def add_noise(image_bgr_u8, level=0.1, rng=np.random, backend="native"):
    """Gaussian noise (p=0.9) or motion blur (p=0.1) (ref: blob.py:102-129)."""
    r = rng.rand(1)
    if r < 0.9:
        row, col = image_bgr_u8.shape[:2]
        sigma = rng.rand(1) * rng.uniform(0, level) * 256
        gauss = sigma * rng.randn(row, col)
        noisy = np.clip(image_bgr_u8 + gauss[:, :, None], 0, 255)   # one value a pixel
    else:
        sizes = [3, 5, 7, 9, 11, 15]
        size = sizes[int(rng.randint(len(sizes)))]
        horizontal = rng.rand(1) < 0.5
        noisy = image_ops.filter_line_u8(image_bgr_u8, size, bool(horizontal[0]), backend)
    return noisy.astype("uint8")
