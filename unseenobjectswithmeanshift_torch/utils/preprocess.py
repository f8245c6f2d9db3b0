"""Preprocessing: depth -> XYZ, UCN and COCO image normalization, padding,
reading a sample from disk.

Port of ``unseenobjectswithmeanshift_tpu.utils.preprocess`` (ref:
lib/fcn/get_network_crop.py:114-153; lib/datasets/tabletop_dataset.py:395-396;
detectron2 ImageList.from_tensors pads bottom/right with zeros). Tensors in,
tensors out, NHWC. ``read_sample`` reads PNG and JPEG through
``utils/image_io`` (no cv2, which the card machine lacks).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..config import COCO_PIXEL_MEAN_RGB, COCO_PIXEL_STD_RGB, UCN_PIXEL_MEANS_BGR


def compute_xyz(depth_m, fx: float, fy: float, px: float, py: float):
    """[H, W] depth in meters -> [H, W, 3] camera-frame (x, y, z)."""
    h, w = depth_m.shape[-2], depth_m.shape[-1]
    rows = torch.arange(h, dtype=depth_m.dtype, device=depth_m.device)[:, None]
    cols = torch.arange(w, dtype=depth_m.dtype, device=depth_m.device)[None, :]
    z = depth_m
    return torch.stack([(cols - px) * z / fx, (rows - py) * z / fy, z], dim=-1)


def normalize_image_ucn(im_bgr_u8):
    """BGR uint8 [..., H, W, 3] -> im/255 - pixel_means/255 (float32)."""
    means = torch.tensor(UCN_PIXEL_MEANS_BGR, dtype=torch.float32,
                         device=im_bgr_u8.device) / 255.0
    return im_bgr_u8.to(torch.float32) / 255.0 - means


def normalize_image_coco(im_rgb_u8):
    """RGB uint8 [..., H, W, 3] -> (im - mean) / std with the COCO statistics
    (float32; ref: lib/datasets/tabletop_dataset.py:395-396)."""
    mean = torch.tensor(COCO_PIXEL_MEAN_RGB, dtype=torch.float32, device=im_rgb_u8.device)
    std = torch.tensor(COCO_PIXEL_STD_RGB, dtype=torch.float32, device=im_rgb_u8.device)
    return (im_rgb_u8.to(torch.float32) - mean) / std


def fov_intrinsics(width: int = 640, height: int = 480, fov_deg: float = 45.0,
                   near: float = 0.01) -> dict:
    """The TOD synthetic camera's intrinsics (ref: tabletop_object.py:57-93;
    the JAX package's ``data.datasets.fov_intrinsics``): the demo's default
    when a folder has depth frames but no camera_params.json."""
    e = 1.0 / math.tan(math.radians(fov_deg / 2.0))
    r = near / e * (width / height)
    focal = near * width / (2 * r)
    return dict(fx=focal, fy=focal, x_offset=width / 2.0, y_offset=height / 2.0)


def pad_to_multiple(x, divisor: int = 32, value: float = 0.0):
    """Pad [..., H, W, C] bottom/right so H and W are multiples of divisor.
    Returns (padded, (orig_h, orig_w))."""
    h, w = x.shape[-3], x.shape[-2]
    ph, pw = (-h) % divisor, (-w) % divisor
    if ph == 0 and pw == 0:
        return x, (h, w)
    return F.pad(x, (0, 0, 0, pw, 0, ph), value=value), (h, w)


def read_sample(color_path: str, depth_path=None, camera_params=None, input_type="RGBD",
                device="cpu"):
    """One RGB(-D) sample from disk (ref: get_network_crop.py:124-153, the
    JAX package's ``read_sample``): {'image': [H, W, 3] float32 normalized
    BGR, 'xyz': [H, W, 3] float32 camera XYZ from the depth PNG (millimetres)
    and ``camera_params`` (fx, fy, x_offset, y_offset), or None for COLOR
    input or without a depth file}, as tensors on ``device``."""
    from .image_io import IMREAD_ANYDEPTH, imread

    im = imread(color_path)                            # BGR uint8
    if im is None:
        raise FileNotFoundError(f"cannot read {color_path}")
    sample = {"image": normalize_image_ucn(torch.from_numpy(im).to(device)), "xyz": None}
    if input_type in ("DEPTH", "RGBD") and depth_path is not None:
        depth = imread(depth_path, IMREAD_ANYDEPTH)
        if depth is None:
            raise FileNotFoundError(f"cannot read {depth_path}")
        depth_m = torch.from_numpy(depth.astype(np.float32) / 1000.0).to(device)
        sample["xyz"] = compute_xyz(depth_m, camera_params["fx"], camera_params["fy"],
                                    camera_params["x_offset"], camera_params["y_offset"])
    return sample
