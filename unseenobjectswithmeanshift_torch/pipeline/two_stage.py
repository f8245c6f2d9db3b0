"""Two-stage (whole image + zoom-in crops) MSMFormer inference.

Port of ``unseenobjectswithmeanshift_tpu.pipeline.two_stage`` (stage1_labels
:42, TwoStagePredictor :64; ref: lib/fcn/test_utils.py:245-421). Stage 1
predicts instances on the whole image; RoI crops are cut on the device; the
crop network runs only on the crops that are present (compact, run, scatter,
with one host sync on the crop count); the refined labels are pasted back.
Stage 1 queues its work with no host sync, so ``stream`` can queue the next
batches' stage 1 before a batch's crop-count sync (JAX :140-160).

Outputs, per image:
  labels  [H, W] int32: stage-1 labels (values 0 and 2..T+1)
  refined [H, W] int32: refined labels (values from 1), or the stage-1 labels
          when no crop is present.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import List, Optional

import torch

from ..config import Config
from ..models.meta_arch import MSMFormer
from .postprocess import (
    combine_masks, filter_labels_depth, get_confident_instances, instance_inference,
)
from .refine import Crops, crop_rois, match_label_crop


def stage1_labels(cfg: Config, outputs, xyz, image_hw, osd: bool = False):
    """Instance extraction -> confident filter -> label image -> depth filter
    for ONE image. outputs: pred_logits [Q, K+1] and either pred_masks
    [Q, H, W] or mask_embed [Q, C] + mask_features [H, W, C]."""
    t = cfg.test
    inst = instance_inference(outputs["pred_logits"], outputs.get("pred_masks"),
                              num_classes=cfg.decoder.num_classes,
                              topk=t.max_instances,
                              mask_embed=outputs.get("mask_embed"),
                              mask_features=outputs.get("mask_features"),
                              out_hw=image_hw)
    inst = get_confident_instances(inst, topk=t.topk, score=t.confident_score,
                                   num_classes=cfg.decoder.num_classes,
                                   low_threshold=t.low_threshold)
    label = combine_masks(inst)
    if xyz is not None:
        thr = t.depth_filter_threshold_osd if osd else t.depth_filter_threshold_ocid
        label = filter_labels_depth(label, xyz[..., 2], thr, max_label=t.max_instances + 2)
    return label, inst


@dataclass
class Stage1:
    """Stage-1 result of a batch: labels [B, H, W] and the crops of each image."""

    labels: torch.Tensor
    crops: List[Crops]


class TwoStagePredictor:
    """Drives the whole-image network, the crops and the crop network.

    model / model_crop: MSMFormer modules on one device, in eval mode.
    Inputs are [B, H, W, 3] normalized BGR images and [B, H, W, 3] XYZ maps
    (None for COLOR input), H and W padded to the size divisibility.
    """

    def __init__(self, model: MSMFormer, model_crop: MSMFormer, cfg: Config,
                 cfg_crop: Optional[Config] = None):
        self.model = model.eval()
        self.model_crop = model_crop.eval()
        self.cfg = cfg
        self.cfg_crop = cfg_crop or cfg

    @torch.inference_mode()
    def stage1(self, image, xyz=None, osd: bool = False) -> Stage1:
        """Whole-image network, labels and crops of a batch, queued on the
        device with no host sync."""
        cfg = self.cfg
        H, W = image.shape[1], image.shape[2]
        out = self.model(image, xyz, light=True)
        labels, crops = [], []
        t = cfg.test
        for b in range(image.shape[0]):
            per = {"pred_logits": out["pred_logits"][b], "mask_embed": out["mask_embed"][b],
                   "mask_features": out["mask_features"][b]}
            xyz_b = None if xyz is None else xyz[b]
            lab, _ = stage1_labels(cfg, per, xyz_b, (H, W), osd=osd)
            labels.append(lab)
            crops.append(crop_rois(image[b], lab, xyz_b, max_instances=t.max_instances,
                                   crop_size=t.crop_size, padding=t.crop_padding))
        return Stage1(torch.stack(labels), crops)

    def _crop_labels(self, rgb, dep):
        """Crop network + per-crop label images for [P, S, S] crops."""
        S = self.cfg.test.crop_size
        tc = self.cfg_crop.test
        nc = self.cfg_crop.decoder.num_classes
        out = self.model_crop(rgb, dep, light=True)
        labels = []
        for p in range(rgb.shape[0]):
            inst = instance_inference(out["pred_logits"][p], None, num_classes=nc,
                                      topk=tc.max_instances,
                                      mask_embed=out["mask_embed"][p],
                                      mask_features=out["mask_features"][p],
                                      out_hw=(S, S))
            inst = get_confident_instances(inst, topk=tc.topk, score=tc.confident_score,
                                           num_classes=nc, low_threshold=tc.low_threshold)
            labels.append(combine_masks(inst))
        return torch.stack(labels)

    @torch.inference_mode()
    def refine(self, s1: Stage1) -> torch.Tensor:
        """Crop network on the present crops, then the paste-back -> [B, H, W]."""
        labels = s1.labels
        T, S = self.cfg.test.max_instances, self.cfg.test.crop_size
        present = torch.stack([c.present for c in s1.crops])          # [B, T]
        idx = torch.nonzero(present.reshape(-1)).flatten()            # host sync
        if idx.numel() == 0:
            return labels
        rgb, dep = compact_crops(s1.crops, idx, T, S)
        labels_p = self._crop_labels(rgb, dep)
        return paste_back(labels, s1.crops, labels_p, idx, self.cfg.test)

    def __call__(self, image, xyz=None, osd: bool = False, refine: bool = True):
        """-> (labels [B, H, W], refined [B, H, W]) int32."""
        s1 = self.stage1(image, xyz, osd=osd)
        if not refine:
            return s1.labels, s1.labels
        return s1.labels, self.refine(s1)

    def stream(self, batches, osd: bool = False, depth: int = 2):
        """Software-pipelined inference over an iterable of (image, xyz)
        batches (JAX two_stage.py:140-160): stage 1 of the next ``depth``
        batches is queued before batch i's crop-count sync, so the card has
        queued work while the host waits and runs batch i's stage 2. Yields
        (labels, refined) per batch, in order, ``depth`` behind; the outputs
        equal ``__call__``'s."""
        yield from stream_batches(lambda b: self.stage1(*b, osd=osd), self.refine, batches,
                                  depth)


def stream_batches(stage1, refine, batches, depth: int):
    """Yields (s1.labels, refine(s1)) for s1 = stage1(batch) of each batch,
    with stage 1 queued ``depth`` batches ahead of each refine."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    pending = deque()
    for batch in batches:
        pending.append(stage1(batch))
        if len(pending) > depth:
            s1 = pending.popleft()
            yield s1.labels, refine(s1)
    while pending:
        s1 = pending.popleft()
        yield s1.labels, refine(s1)


def compact_crops(crops: List[Crops], idx, T: int, S: int):
    """The rgb and xyz (None for COLOR input) crops of the slots ``idx`` of
    the flattened [B * T] slot layout."""
    B = len(crops)
    rgb = torch.stack([c.rgb for c in crops]).reshape(B * T, S, S, 3)[idx]
    if crops[0].xyz is None:
        return rgb, None
    return rgb, torch.stack([c.xyz for c in crops]).reshape(B * T, S, S, 3)[idx]


def paste_back(labels, crops: List[Crops], labels_p, idx, t):
    """Scatter the per-crop labels ``labels_p`` [P, S, S] of the slots
    ``idx`` back to the [B, T] layout and paste them into each image;
    images without a crop keep ``labels``. -> [B, H, W]."""
    B, H, W = labels.shape
    T, S = t.max_instances, t.crop_size
    labels_crop = torch.zeros((B * T, S, S), dtype=labels_p.dtype, device=labels.device)
    labels_crop[idx] = labels_p
    labels_crop = labels_crop.reshape(B, T, S, S)
    refined = []
    for b, c in enumerate(crops):
        depth = None if c.xyz is None else c.xyz[..., 2]
        r = match_label_crop(labels_crop[b], c.mask, c.rois, depth, c.present, (H, W),
                             overlap_threshold=t.overlap_match_threshold)
        refined.append(torch.where(c.present.any(), r, labels[b]))
    return torch.stack(refined)
