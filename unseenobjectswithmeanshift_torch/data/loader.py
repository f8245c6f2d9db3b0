"""Host-side batching helpers of the dataset readers.

Port of ``unseenobjectswithmeanshift_tpu.data.loader`` (:21-48):
``label_image_to_instances`` (the detectron2 Instances role, ref:
MSMFormer/meanshiftformer/data/dataset_mappers/unseen_instance_dataset_mapper.py)
and ``pad_hw`` (detectron2's size-divisibility padding). ``BatchLoader``,
the shuffling training loader, comes with training on files (ROADMAP queue
1 item 12).
"""

from __future__ import annotations

import numpy as np


def label_image_to_instances(label, max_gt: int):
    """[H, W] int32 label image (0 = background) -> (masks [G, H, W] float32,
    labels [G] int32 (=1, 'object'), valid [G] bool, contiguous, renumbered
    [H, W] label image with instance i in slot i+1 - the contiguous-cluster form
    the embedding loss consumes; background stays 0)."""
    H, W = label.shape
    masks = np.zeros((max_gt, H, W), np.float32)
    valid = np.zeros(max_gt, bool)
    renumbered = np.zeros((H, W), np.int32)
    ids = np.unique(label)
    ids = ids[ids > 0][:max_gt]
    for i, v in enumerate(ids):
        m = label == v
        masks[i] = m
        valid[i] = True
        renumbered[m] = i + 1
    labels = np.ones(max_gt, np.int32)
    return masks, labels, valid, renumbered


def pad_hw(arr, divisor=32):
    """Pad [H, W, ...] bottom/right to a multiple of divisor."""
    h, w = arr.shape[:2]
    ph, pw = (-h) % divisor, (-w) % divisor
    if ph == 0 and pw == 0:
        return arr
    pad = [(0, ph), (0, pw)] + [(0, 0)] * (arr.ndim - 2)
    return np.pad(arr, pad)
