"""Dataset readers: OCID / OSD (real-world evaluation), the Tabletop Object
Dataset's test split, pushing / mixture (RSS'23 fine-tuning).

Port of ``unseenobjectswithmeanshift_tpu.data.datasets``, equal to it
sample for sample. Every reader returns host-side numpy samples (HWC):
  {'image': [H,W,3] float32 normalized BGR (UCN convention),
   'xyz':   [H,W,3] float32 or None,
   'label': [H,W] int32 (0 background; objects 1..K-1 after remapping),
   'file_name': str}

Images are read by ``utils/image_io`` (PNG and baseline JPEG without cv2 or
PIL), clouds by ``data/pcd``, both through the native host library; the
training crops and augmentations are ``data/image_ops`` and
``data/augmentation`` (cv2's semantics without cv2). So every reader here
runs on a machine without cv2 and PIL.

Semantics of the reference datasets:
- OCIDObject (ref: lib/datasets/ocid_object.py): label 1 (table) -> 0, label 2
  -> 0 for 'table' sequences, XYZ from organized .pcd
- OSDObject (ref: lib/datasets/osd_object.py): annotations + .pcd
- TableTopObject (ref: lib/datasets/tabletop_object.py): 7 views a scene (5
  for crop training, views 2..6), table (label 1) -> background, labels
  remapped to 0..K-1, fov intrinsics for depth -> XYZ, depth-noise
  augmentation, SYN_CROP square padded crops at 224, pixel sampling for the
  embedding loss, chromatic and noise augmentation of the colour image; the
  draws from its ``np.random.RandomState(seed)`` in the JAX reader's order.
  The procedural ``synthetic_tabletop`` entry serves
  ``data/synthetic.SyntheticTabletopDataset`` (host-rendered scenes; its
  root, where given, is the scene count). The ``*_uoais`` entries are
  ``data/uoais.py``'s readers.
- PushingDataset / MixtureDataset (ref: lib/datasets/pushing_dataset.py,
  mixture_dataset.py): real robot sequences, 1:3 pushing:tabletop mixture
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional

import numpy as np

from ..config import UCN_PIXEL_MEANS_BGR
from ..utils.image_io import IMREAD_ANYDEPTH, imread, imread_indexed
from . import augmentation as aug
from .image_ops import resize_linear_u8, resize_nearest
from .loader import label_ids
from .pcd import read_pcd_xyz


def compute_xyz(depth_m, fx: float, fy: float, px: float, py: float):
    """[H, W] depth in meters (numpy) -> [H, W, 3] camera-frame (x, y, z)
    (ref: lib/fcn/get_network_crop.py:114-121; the JAX package's numpy path)."""
    h, w = depth_m.shape[-2], depth_m.shape[-1]
    rows = np.arange(h, dtype=depth_m.dtype)[:, None]
    cols = np.arange(w, dtype=depth_m.dtype)[None, :]
    z = depth_m
    x = (cols - px) * z / fx
    y = (rows - py) * z / fy
    return np.stack([x, y, z], axis=-1)


def normalize_bgr(im_bgr_u8):
    means = np.asarray(UCN_PIXEL_MEANS_BGR, np.float32) / 255.0
    return im_bgr_u8.astype(np.float32) / 255.0 - means


def remap_labels(labels):
    """Map the unique labels to 0..K-1 (ref: process_label)."""
    return np.searchsorted(label_ids(labels), labels).astype(np.int32)


def fov_intrinsics(width=640, height=480, fov_deg=45.0, near=0.01):
    """The TOD synthetic-camera intrinsics (ref: tabletop_object.py:57-93)."""
    aspect = width / height
    e = 1.0 / np.tan(np.radians(fov_deg / 2.0))
    t = near / e
    r = t * aspect
    alpha = width / (2 * r)
    focal = near * alpha
    return dict(fx=focal, fy=focal, x_offset=width / 2.0, y_offset=height / 2.0)


def _must_read(path, flags=1):
    im = imread(path, flags)
    if im is None:
        raise FileNotFoundError(path)
    return im


def mask_to_tight_box_np(mask):
    ys, xs = np.nonzero(mask)
    return xs.min(), ys.min(), xs.max(), ys.max()


class TableTopObject:
    """UCN-format TOD reader (280k synthetic images)."""

    def __init__(self, root, image_set="train", input_type="RGBD",
                 use_augmentation=True, syn_crop=False, crop_size=224,
                 min_padding=0.5, max_padding=1.0,
                 sampling=False, sampling_num=1000, chromatic=True,
                 add_noise=True, seed=None):
        self.root = root
        self.input_type = input_type
        self.use_augmentation = use_augmentation
        self.syn_crop = syn_crop
        self.crop_size = crop_size
        self.min_padding = min_padding
        self.max_padding = max_padding
        self.sampling = sampling
        self.sampling_num = sampling_num
        self.chromatic = chromatic
        self.add_noise = add_noise
        self.rng = np.random.RandomState(seed)
        self.views_per_scene = 5 if syn_crop else 7

        sets = {"train": ["training_set"], "test": ["test_set"],
                "all": ["training_set", "test_set"]}[image_set]
        self.scene_dirs = []
        for s in sets:
            self.scene_dirs += sorted(glob.glob(os.path.join(root, s, "*")))
        self.intrinsics = fov_intrinsics()

    def __len__(self):
        return len(self.scene_dirs) * self.views_per_scene

    def process_depth(self, depth_u16):
        depth = (depth_u16 / 1000.0).astype(np.float32)
        if self.use_augmentation:
            depth = aug.add_noise_to_depth(depth, rng=self.rng)
            depth = aug.dropout_random_ellipses(depth, rng=self.rng)
        xyz = compute_xyz(depth, self.intrinsics["fx"], self.intrinsics["fy"],
                          self.intrinsics["x_offset"], self.intrinsics["y_offset"])
        if self.use_augmentation:
            xyz = aug.add_noise_to_xyz(xyz, depth, rng=self.rng)
        return xyz

    def pad_crop_resize(self, img, label, xyz):
        """Square padded crop around a random object, resized to crop_size
        (ref: tabletop_object.py:175-237; cv2 linear for rgb, nearest for
        label and xyz)."""
        H, W = label.shape
        K = int(label.max())
        while True:
            idx = self.rng.randint(1, K + 1) if K > 0 else 0
            fg = (label == idx).astype(np.float32)
            if fg.sum() == 0:
                continue
            x_min, y_min, x_max, y_max = mask_to_tight_box_np(fg)
            cx, cy = (x_min + x_max) / 2, (y_min + y_max) / 2
            xd, yd = x_max - x_min, y_max - y_min
            if xd > yd:
                y_min, y_max = cy - xd / 2, cy + xd / 2
            else:
                x_min, x_max = cx - yd / 2, cx + yd / 2
            side = x_max - x_min
            pad = int(round(side * self.rng.uniform(self.min_padding, self.max_padding)))
            if pad == 0:
                pad = 25
            x_min = max(int(x_min - pad), 0)
            x_max = min(int(x_max + pad), W - 1)
            y_min = max(int(y_min - pad), 0)
            y_max = min(int(y_max + pad), H - 1)
            if y_min == y_max or x_min == x_max:
                continue
            break
        s = self.crop_size
        img_c = resize_linear_u8(img[y_min:y_max + 1, x_min:x_max + 1], s, s)
        lab_c = resize_nearest(label[y_min:y_max + 1, x_min:x_max + 1], s, s)
        xyz_c = None
        if xyz is not None:
            xyz_c = resize_nearest(xyz[y_min:y_max + 1, x_min:x_max + 1], s, s)
        return img_c, lab_c, xyz_c

    def sample_pixels(self, labels, num=1000):
        """Per-cluster pixel subsampling for the embedding loss (-1 = ignore)
        (ref: tabletop_object.py:241-254)."""
        out = -np.ones_like(labels)
        for i in range(int(labels.max()) + 1):
            ys, xs = np.where(labels == i)
            n = len(ys)
            if n <= num:
                out[ys, xs] = i
            else:
                sel = self.rng.permutation(n)[:num]
                out[ys[sel], xs[sel]] = i
        return out

    def __getitem__(self, idx):
        scene_dir = self.scene_dirs[idx // self.views_per_scene]
        view = idx % self.views_per_scene
        if self.syn_crop:
            view += 2

        label = imread_indexed(os.path.join(scene_dir, "segmentation_%05d.png" % view))
        label[label == 1] = 0           # table -> background
        label = remap_labels(label)
        im = _must_read(os.path.join(scene_dir, "rgb_%05d.jpeg" % view))

        xyz = None
        if self.input_type in ("DEPTH", "RGBD"):
            depth = _must_read(os.path.join(scene_dir, "depth_%05d.png" % view),
                               IMREAD_ANYDEPTH)
            xyz = self.process_depth(depth)

        if self.syn_crop:
            im, label, xyz = self.pad_crop_resize(im, label, xyz)
            label = remap_labels(label)

        sample_label = label
        if self.sampling:
            sample_label = self.sample_pixels(label, self.sampling_num)

        if self.chromatic and self.rng.rand(1) > 0.1:
            im = aug.chromatic_transform(im, rng=self.rng)
        if self.add_noise and self.rng.rand(1) > 0.1:
            im = aug.add_noise(im, rng=self.rng)

        return {"image": normalize_bgr(im), "xyz": xyz,
                "label": sample_label.astype(np.int32),
                "file_name": os.path.join(scene_dir, "rgb_%05d.jpeg" % view)}


class OCIDObject:
    """OCID real-world eval set (2390 images)."""

    def __init__(self, root, input_type="RGBD"):
        self.root = root
        self.input_type = input_type
        self.image_paths = sorted(glob.glob(
            os.path.join(root, "**", "rgb", "*.png"), recursive=True))

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, idx):
        filename = self.image_paths[idx]
        im = _must_read(filename)
        h, w = im.shape[:2]

        labels_filename = filename.replace("rgb", "label")
        label = imread_indexed(labels_filename)
        label[label == 1] = 0                       # table
        if "table" in labels_filename:
            label[label == 2] = 0                   # floor under 'table' sequences
        label = remap_labels(label)

        sample = {"image": normalize_bgr(im), "label": label, "file_name": filename,
                  "xyz": None}
        if self.input_type in ("DEPTH", "RGBD"):
            pcd_file = filename.replace("rgb", "pcd").replace(".png", ".pcd")
            sample["xyz"] = read_pcd_xyz(pcd_file).reshape(h, w, 3)
        return sample


class OSDObject:
    """OSD real-world eval set (111 images)."""

    def __init__(self, root, input_type="RGBD"):
        self.root = root
        self.input_type = input_type
        self.image_files = sorted(glob.glob(os.path.join(root, "image_color", "*.png")))

    def __len__(self):
        return len(self.image_files)

    def __getitem__(self, idx):
        filename = self.image_files[idx]
        im = _must_read(filename)
        h, w = im.shape[:2]
        label = remap_labels(imread_indexed(
            filename.replace("image_color", "annotation")))
        sample = {"image": normalize_bgr(im), "label": label, "file_name": filename,
                  "xyz": None}
        if self.input_type in ("DEPTH", "RGBD"):
            pcd_file = filename.replace("image_color", "pcd").replace(".png", ".pcd")
            sample["xyz"] = read_pcd_xyz(pcd_file).reshape(h, w, 3)
        return sample


class PushingDataset:
    """Real robot-pushing sequences for self-supervised fine-tuning
    (ref: lib/datasets/pushing_dataset.py): per-frame color/depth/label pngs
    listed in a index file or directory tree; record format identical to TOD."""

    def __init__(self, root, input_type="RGBD", camera_params: Optional[dict] = None):
        self.root = root
        self.input_type = input_type
        self.color_files = sorted(glob.glob(
            os.path.join(root, "**", "*color*.png"), recursive=True)) or sorted(
            glob.glob(os.path.join(root, "**", "*color*.jpg"), recursive=True))
        params_file = os.path.join(root, "camera_params.json")
        if camera_params is None and os.path.exists(params_file):
            with open(params_file) as f:
                camera_params = json.load(f)
        self.camera_params = camera_params or fov_intrinsics()

    def __len__(self):
        return len(self.color_files)

    def __getitem__(self, idx):
        filename = self.color_files[idx]
        im = _must_read(filename)
        label_file = filename.replace("color", "label")
        label = (imread_indexed(label_file) if os.path.exists(label_file)
                 else np.zeros(im.shape[:2], np.int32))
        label = remap_labels(label)
        xyz = None
        if self.input_type in ("DEPTH", "RGBD"):
            depth_file = filename.replace("color", "depth")
            depth = _must_read(depth_file, IMREAD_ANYDEPTH).astype(np.float32) / 1000.0
            p = self.camera_params
            xyz = compute_xyz(depth, p["fx"], p["fy"], p["x_offset"], p["y_offset"])
        return {"image": normalize_bgr(im), "xyz": xyz, "label": label,
                "file_name": filename}


class MixtureDataset:
    """1:3 pushing:tabletop mixture (ref: lib/datasets/mixture_dataset.py:50-56:
    idx % 4 == 0 -> pushing, else tabletop)."""

    def __init__(self, pushing, tabletop):
        self.pushing = pushing
        self.tabletop = tabletop

    def __len__(self):
        return len(self.tabletop)

    def __getitem__(self, idx):
        if idx % 4 == 0 and len(self.pushing) > 0:
            return self.pushing[(idx // 4) % len(self.pushing)]
        return self.tabletop[idx]


def _uoais(name):
    def make(root, **kwargs):
        from . import uoais            # uoais imports from this module

        return getattr(uoais, name)(root, **kwargs)
    return make


def _synthetic_tabletop(root=None, **kwargs):
    """Host-rendered scenes (data/synthetic.py): no files; root, where
    given, is the scene count."""
    from .synthetic import SyntheticTabletopDataset   # synthetic imports this module

    if root not in (None, ""):
        kwargs.setdefault("num_scenes", int(root))
    return SyntheticTabletopDataset(**kwargs)


DATASETS = {
    "tabletop_object": TableTopObject,
    "ocid_object": OCIDObject,
    "osd_object": OSDObject,
    "pushing": PushingDataset,
    "osd_object_uoais": _uoais("OSDObjectUOAIS"),
    "ocid_object_uoais": _uoais("OCIDObjectUOAIS"),
    "synthetic_tabletop": _synthetic_tabletop,
}


def get_dataset(name: str, root: str, **kwargs):
    """Name registry (ref: lib/datasets/factory.py): e.g.
    get_dataset('ocid_object', root)."""
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(DATASETS)}")
    return DATASETS[name](root, **kwargs)
