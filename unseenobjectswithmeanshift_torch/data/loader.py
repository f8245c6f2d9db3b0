"""Host-side batching of the dataset readers.

Port of ``unseenobjectswithmeanshift_tpu.data.loader`` (:21-154):
``label_image_to_instances`` (the detectron2 Instances role, ref:
MSMFormer/meanshiftformer/data/dataset_mappers/unseen_instance_dataset_mapper.py),
``pad_hw`` (detectron2's size-divisibility padding) and ``BatchLoader``,
the shuffling training loader, whose numpy batches equal the JAX loader's
for the same dataset and seed.

``BatchLoader`` reads, augments and collates on one producer thread ahead
of the consumer (``prefetch`` batches, a bounded queue; 0 is synchronous),
so the readers' draws keep the JAX order; an error in the thread is raised
in the consumer. With ``device`` set, the producer writes each batch once
into torch tensors, pinned on a CUDA device, and the consumer copies them
with ``non_blocking=True``: the batch arrives as torch tensors with the
trainer's keys. ``masks=False`` leaves out ``gt_masks``, ``gt_labels`` and
``gt_valid`` (the UCN embedding loss reads ``label_image`` only; the masks
of a B=16 480x640 batch are 472 MB at 24 slots).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch


def label_ids(labels) -> np.ndarray:
    """np.unique of an integer label image, by counting over the values'
    span (np.unique's sort past 2^24 values)."""
    if labels.size == 0:
        return np.unique(labels)
    lo, hi = int(labels.min()), int(labels.max())
    if hi - lo >= 1 << 24:
        return np.unique(labels)
    return np.flatnonzero(np.bincount((labels - lo).ravel(), minlength=hi - lo + 1)) + lo


def label_image_to_instances(label, max_gt: int):
    """[H, W] int32 label image (0 = background) -> (masks [G, H, W] float32,
    labels [G] int32 (=1, 'object'), valid [G] bool, contiguous, renumbered
    [H, W] label image with instance i in slot i+1 - the contiguous-cluster form
    the embedding loss consumes; background stays 0)."""
    H, W = label.shape
    masks = np.zeros((max_gt, H, W), np.float32)
    valid = np.zeros(max_gt, bool)
    renumbered = renumber(label, max_gt)
    for i in range(int(renumbered.max(initial=0))):
        masks[i] = renumbered == i + 1
        valid[i] = True
    labels = np.ones(max_gt, np.int32)
    return masks, labels, valid, renumbered


def renumber(label, max_gt: int) -> np.ndarray:
    """The renumbered label image of label_image_to_instances: the first
    max_gt positive ids, in the order of their values, become 1..max_gt;
    every other pixel 0."""
    ids = label_ids(label)
    keep = ids[ids > 0][:max_gt]
    if keep.size == 0:
        return np.zeros(label.shape, np.int32)
    pos = np.searchsorted(keep, label)
    hit = keep[np.minimum(pos, keep.size - 1)] == label
    return np.where(hit, pos + 1, 0).astype(np.int32)


def pad_hw(arr, divisor=32):
    """Pad [H, W, ...] bottom/right to a multiple of divisor."""
    h, w = arr.shape[:2]
    ph, pw = (-h) % divisor, (-w) % divisor
    if ph == 0 and pw == 0:
        return arr
    pad = [(0, ph), (0, pw)] + [(0, 0)] * (arr.ndim - 2)
    return np.pad(arr, pad)


class BatchLoader:
    """Shuffling batch iterator producing fixed-shape training batches
    (the role of the reference's detectron2 loader, ref:
    tabletop_train_net_pretrained.py:92-101 build_detection_train_loader).
    Each pass over the dataset draws a new order from one
    ``np.random.RandomState(seed)``."""

    def __init__(self, dataset, batch_size: int, max_gt: int = 24,
                 size_divisibility: int = 32, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 2,
                 device=None, masks: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.div = size_divisibility
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.device = None if device is None else torch.device(device)
        self.masks = masks

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _produce(self) -> Iterator[Dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        batch = []
        for idx in order:
            batch.append(self.dataset[int(idx)])
            if len(batch) == self.batch_size:
                yield self._assemble(batch)
                batch = []
        if batch and not self.drop_last:
            yield self._assemble(batch)

    def _assemble(self, samples):
        """The numpy batch (collate), or with a device torch tensors written
        once from the samples, in pinned memory for a CUDA device (no
        np.stack then a pinning copy: two passes over ~140 MB a B=16 batch)."""
        if self.device is None:
            return self.collate(samples)
        fields, names = self._fields(samples)
        pin = self.device.type == "cuda"
        out = {"file_name": names}
        for k, arrays in fields.items():
            t = torch.empty((len(arrays),) + arrays[0].shape,
                            dtype=torch.from_numpy(arrays[0][:0]).dtype, pin_memory=pin)
            view = t.numpy()
            for i, a in enumerate(arrays):
                view[i] = a
            out[k] = t
        return out

    def _deliver(self, batch):
        if self.device is None:
            return batch
        return {k: v.to(self.device, non_blocking=True) if torch.is_tensor(v) else v
                for k, v in batch.items()}

    def __iter__(self) -> Iterator[Dict]:
        if self.prefetch <= 0:
            for item in self._produce():
                yield self._deliver(item)
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        _END = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self._produce():
                    if not put(item):
                        return   # consumer abandoned iteration
                put(_END)
            except BaseException as e:  # surface worker errors to the consumer
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield self._deliver(item)
        finally:
            stop.set()
            t.join()

    def _fields(self, samples):
        """({key: the samples' arrays, padded to the size divisibility},
        file names)."""
        fields = {"image": [], "label_image": []}
        if self.masks:
            fields.update(gt_masks=[], gt_labels=[], gt_valid=[])
        if samples[0].get("xyz") is not None:
            fields["xyz"] = []
        for s in samples:
            fields["image"].append(pad_hw(s["image"], self.div))
            lab = pad_hw(s["label"], self.div)
            if "xyz" in fields:
                fields["xyz"].append(pad_hw(s["xyz"], self.div))
            if self.masks:
                m, l, v, renum = label_image_to_instances(lab, self.max_gt)
                fields["gt_masks"].append(m)
                fields["gt_labels"].append(l)
                fields["gt_valid"].append(v)
            else:
                renum = renumber(lab, self.max_gt)
            fields["label_image"].append(renum)
        return fields, [s.get("file_name") for s in samples]

    def collate(self, samples) -> Dict[str, np.ndarray]:
        """Samples -> the JAX loader's batch: image [B, H, W, 3], xyz (when
        the samples have it), label_image [B, H, W] int32 (instances
        renumbered 1..), and with masks gt_masks [B, G, H, W], gt_labels,
        gt_valid [B, G]; H and W padded to the size divisibility. Beside
        them file_name, the samples' names (a list)."""
        fields, names = self._fields(samples)
        batch = {k: np.stack(v) for k, v in fields.items()}
        batch["file_name"] = names
        return batch


def batch_checksum(batch: Dict) -> Optional[float]:
    """A float64 sum of a batch's image, xyz and label image (on the host):
    a fingerprint to tell two runs' batches apart."""
    total = 0.0
    for k in ("image", "xyz", "label_image"):
        v = batch.get(k)
        if v is None:
            continue
        v = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        total += float(v.astype(np.float64).sum())
    return total
