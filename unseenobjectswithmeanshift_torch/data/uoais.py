"""UOAIS-format data: normalized / inpainted 3-channel depth and the
COCO-JSON synthetic dataset, without pycocotools.

Port of ``unseenobjectswithmeanshift_tpu.data.uoais``, equal to it sample
for sample:
- normalize_depth / unnormalize_depth / inpaint_depth: ref lib/datasets/
  load_OSD_UOAIS.py:6-60 (mm depth clipped to [250, 1500] -> uint8 x3
  channels; Telea inpainting of zero-depth holes)
- rle_decode / rle_encode / ann_to_mask: a minimal COCO RLE codec
  (uncompressed counts and pycocotools' compressed string encoding)
- UOAISSimDataset: COCO-JSON reader (ref: lib/datasets/uoais_dataset.py
  load_uoais_json), yielding the standard sample dict
- OSDObjectUOAIS / OCIDObjectUOAIS: eval variants with the normalized-depth
  pipeline instead of XYZ (ref: load_OSD_UOAIS.py, load_OCID_UOAIS.py:119-130)

Nothing here imports OpenCV: ``inpaint_depth``'s resizes, dilation and
Telea inpainting, the polygon fill and the OCID depth resize are
``data/image_ops.py``'s operations, equal to OpenCV's, on the native host
library (their numpy twins behind ``backend="numpy"``).
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from ..config import COCO_PIXEL_MEAN_RGB, COCO_PIXEL_STD_RGB
from ..utils.image_io import IMREAD_ANYDEPTH, imread, imread_indexed
from . import image_ops
from .datasets import _must_read, normalize_bgr, remap_labels


def normalize_depth(depth_mm, min_val=250.0, max_val=1500.0):
    d = np.clip(depth_mm.astype(np.float32), min_val, max_val)
    d = (d - min_val) / (max_val - min_val) * 255
    return np.uint8(np.repeat(d[..., None], 3, -1))


def unnormalize_depth(depth_u8x3, min_val=250.0, max_val=1500.0):
    return np.float32(depth_u8x3) / 255 * (max_val - min_val) + min_val


def _resize_linear(img, h, w, backend):
    """OpenCV's resize to (h, w), INTER_LINEAR; at the same size it returns
    the pixels unchanged."""
    if img.shape[:2] == (h, w):
        return img.copy()
    return image_ops.resize_linear_u8(img, h, w, backend=backend)


def inpaint_depth(depth_u8x3, factor=1, kernel_size=3, dilate=False, backend="native"):
    """Telea-inpaint the zero pixels of a normalized uint8 x3 depth (at 1 /
    factor of its size), as the reference does with OpenCV."""
    H, W, _ = depth_u8x3.shape
    resized = _resize_linear(depth_u8x3, H // factor, W // factor, backend)
    mask = np.all(resized == 0, axis=2).astype(np.uint8)
    if dilate:
        mask = image_ops.dilate_u8(mask, kernel_size, backend=backend)
    inpainted = image_ops.inpaint_telea(resized, mask, kernel_size, backend=backend)
    inpainted = _resize_linear(inpainted, H, W, backend)
    return np.where(depth_u8x3 == 0, inpainted, depth_u8x3)


# ---------------------------------------------------------------------------
# minimal COCO RLE codec
# ---------------------------------------------------------------------------

def _rle_string_decode(s: str):
    """Decode pycocotools' compressed RLE 'counts' string to a counts list."""
    counts = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_decode(rle, height=None, width=None):
    """COCO RLE (dict with 'counts' + 'size') -> [H, W] uint8 mask.

    Column-major runs starting with background, matching pycocotools.
    """
    if isinstance(rle, dict):
        h, w = rle["size"]
        counts = rle["counts"]
    else:
        h, w = height, width
        counts = rle
    if isinstance(counts, str):
        counts = _rle_string_decode(counts)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        flat[pos:pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape(w, h).T  # column-major


def rle_encode(mask):
    """[H, W] binary -> uncompressed COCO RLE dict (column-major counts)."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).T.reshape(-1)
    change = np.nonzero(np.diff(flat))[0] + 1
    idx = np.concatenate([[0], change, [len(flat)]])
    counts = np.diff(idx).tolist()
    if flat[0] == 1:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def ann_to_mask(ann, height, width):
    """COCO annotation segmentation -> binary mask (polygon or RLE)."""
    seg = ann["segmentation"]
    if isinstance(seg, dict):
        return rle_decode(seg)
    mask = np.zeros((height, width), np.uint8)
    for poly in seg:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        image_ops.fill_poly(mask, np.round(pts).astype(np.int32), 1)
    return mask


class UOAISSimDataset:
    """UOAIS-Sim COCO-JSON synthetic dataset (ref: lib/datasets/uoais_dataset.py).

    root should contain the json (annotations) and the image folders referenced
    by the records' file_name / depth_file_name fields.
    """

    def __init__(self, root, json_file, input_type="RGBD", depth_range=(2500.0, 15000.0)):
        self.root = root
        self.input_type = input_type
        self.depth_range = depth_range
        with open(os.path.join(root, json_file)) as f:
            coco = json.load(f)
        self.images = {im["id"]: im for im in coco["images"]}
        self.anns_by_image = {}
        for a in coco["annotations"]:
            self.anns_by_image.setdefault(a["image_id"], []).append(a)
        self.ids = sorted(self.images)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx):
        info = self.images[self.ids[idx]]
        h, w = info["height"], info["width"]
        path = os.path.join(self.root, info["file_name"])
        im = _must_read(path)
        anns = self.anns_by_image.get(self.ids[idx], [])
        label = np.zeros((h, w), np.int32)
        for i, a in enumerate(anns):
            label[ann_to_mask(a, h, w) > 0] = i + 1

        sample = {"image": normalize_bgr(im), "label": label,
                  "file_name": path, "xyz": None}
        depth_name = info.get("depth_file_name")
        if self.input_type in ("DEPTH", "RGBD") and depth_name:
            depth = _must_read(os.path.join(self.root, depth_name),
                               IMREAD_ANYDEPTH).astype(np.float32)
            d3 = inpaint_depth(normalize_depth(depth, *self.depth_range))
            sample["xyz"] = d3.astype(np.float32) / 255.0
        return sample


class OSDObjectUOAIS:
    """OSD with the UOAIS depth pipeline (ref: lib/datasets/load_OSD_UOAIS.py)."""

    def __init__(self, root, input_type="RGBD"):
        self.root = root
        self.input_type = input_type
        self.image_files = sorted(glob.glob(os.path.join(root, "image_color", "*.png")))

    def __len__(self):
        return len(self.image_files)

    def __getitem__(self, idx):
        filename = self.image_files[idx]
        im = _must_read(filename)
        label = remap_labels(imread_indexed(
            filename.replace("image_color", "annotation")))
        sample = {"image": normalize_bgr(im), "label": label,
                  "file_name": filename, "xyz": None}
        if self.input_type in ("DEPTH", "RGBD"):
            depth = imread(filename.replace("image_color", "disparity"), IMREAD_ANYDEPTH)
            if depth is None:
                depth = _must_read(filename.replace("image_color", "depth"), IMREAD_ANYDEPTH)
            d3 = inpaint_depth(normalize_depth(depth.astype(np.float32)))
            sample["xyz"] = d3.astype(np.float32) / 255.0
        return sample


class OCIDObjectUOAIS:
    """OCID with the UOAIS depth pipeline (ref: lib/datasets/load_OCID_UOAIS.py
    :119-130): normalized (mm -> 0..255, 250..1500 range) + Telea-inpainted
    3-channel depth instead of point-cloud XYZ, and COCO RGB normalization for
    the color image (:94-95)."""

    def __init__(self, root, input_type="RGBD"):
        self.root = root
        self.input_type = input_type
        # the reference lists **/seq* dirs, then each seq's rgb/*.png (:45-53)
        seqs = sorted(glob.glob(os.path.join(root, "**", "*seq*"), recursive=True))
        self.image_paths = []
        for seq in seqs:
            self.image_paths += sorted(glob.glob(os.path.join(seq, "rgb", "*.png")))

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, idx):
        filename = self.image_paths[idx]
        # BGR -> RGB (the reference's cvtColor COLOR_BGR2RGB swaps the channels)
        im = _must_read(filename)[..., ::-1].astype(np.float32)
        image = (im - np.asarray(COCO_PIXEL_MEAN_RGB, np.float32)) / np.asarray(
            COCO_PIXEL_STD_RGB, np.float32)

        labels_filename = filename.replace("rgb", "label")
        label = imread_indexed(labels_filename)
        label[label == 1] = 0                       # table -> background (:101)
        if "table" in labels_filename:
            label[label == 2] = 0                   # floor in 'table' seqs (:102-103)
        label = remap_labels(label)

        sample = {"image": image, "label": label, "file_name": filename,
                  "xyz": None}
        if self.input_type in ("DEPTH", "RGBD"):
            depth = _must_read(filename.replace("rgb", "depth"), IMREAD_ANYDEPTH).astype(np.float32)
            d3 = normalize_depth(depth)
            d3 = image_ops.resize_nearest(d3, 480, 640)   # (:124) INTER_NEAREST
            d3 = inpaint_depth(d3) / 255.0          # (:125-128)
            sample["xyz"] = d3.astype(np.float32)
        return sample
