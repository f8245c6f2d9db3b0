"""UCN two-stage inference: SEGNET embeddings -> vMF mean-shift clustering ->
zoom-in refinement with a crop SEGNET.

Port of ``unseenobjectswithmeanshift_tpu.pipeline.ucn`` (_cluster_batched :43,
UCNPredictor :76; ref: lib/fcn/test_dataset.py:232-321 test_sample):

  features = SEGNET(image, xyz)                  [B, H, W, 64] unit vectors
  labels   = mean-shift clustering (kappa 20, 100 seeds, 10 steps)
  labels   = filter_labels_depth, then renumbered 1..K by cluster size
  crops    = crop_rois on the labels shifted by +1 (object k in slot k-1)
  crop features -> clustering -> labels +1 -> match_label_crop paste-back

Cluster label 0 is the largest cluster (background). On a CUDA tensor the
seeding runs on the FPS kernel, the connected components of the climbed seeds
on their kernel, and with ``mean_shift.use_pallas`` the hill climbing too on
the fused kernel (``ops/mean_shift_kernels.py``, ``ops/mean_shift.py``): the
embedding may be 64-d or, with 'cat' fusion, 128-d. Stage 1 queues with no
host sync. The crop network runs only on the crops that are present,
compacted with one host sync on the crop count and the dropped clusters, as
``pipeline/two_stage.py`` does; ``stream`` queues the next batches' stage 1
before it (JAX ucn.py:166-185).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from ..config import Config
from ..models.segnet import SEGNET
from ..ops.mean_shift_kernels import mean_shift_smart_init_fps, mean_shift_smart_init_fused
from .postprocess import filter_labels_depth, renumber_labels_by_size
from .refine import Crops, crop_rois
from .two_stage import compact_crops, paste_back, stream_batches


def _cluster_batched(X, ms, first_seed_idx):
    """[B, N, C] embeddings -> [B, N] int32 cluster labels."""
    fn = mean_shift_smart_init_fused if ms.use_pallas else mean_shift_smart_init_fps
    labels, _ = fn(X, kappa=ms.kappa, num_seeds=ms.num_seeds, max_iters=ms.max_iters,
                   epsilon=ms.epsilon, first_seed_idx=first_seed_idx)
    return labels


@dataclass
class UCNStage1:
    """Stage-1 result of a batch: labels [B, H, W] int32 (0 background,
    objects 1..K by descending size), cluster counts K [B] and the crops."""

    labels: torch.Tensor
    n_clusters: torch.Tensor
    crops: List[Crops]


class UCNPredictor:
    """Two-stage UCN predictor (whole-image SEGNET + crop SEGNET).

    network / network_crop: SEGNETs on one device, in eval mode. Inputs are
    [B, H, W, 3] normalized BGR images and [B, H, W, 3] XYZ maps (None for
    COLOR input: no depth filter)."""

    def __init__(self, network: SEGNET, network_crop: SEGNET, cfg: Config,
                 cfg_crop: Optional[Config] = None):
        self.network = network.eval()
        self.network_crop = network_crop.eval()
        self.cfg = cfg
        self.cfg_crop = cfg_crop or cfg

    def cluster(self, features, first_seed_idx=0):
        """[B, H, W, C] embeddings -> [B, H, W] int32 cluster labels."""
        B, H, W, C = features.shape
        X = features.reshape(B, H * W, C).float().contiguous()
        return _cluster_batched(X, self.cfg.mean_shift, first_seed_idx).reshape(B, H, W)

    @torch.inference_mode()
    def stage1(self, image, xyz=None, depth_threshold: float = 0.8,
               first_seed_idx=0) -> UCNStage1:
        """Embeddings, clustering, labels and crops of a batch, queued on the
        device with no host sync."""
        ms, t = self.cfg.mean_shift, self.cfg.test
        labels = self.cluster(self.network(image, xyz), first_seed_idx)
        out, counts, crops = [], [], []
        for b in range(labels.shape[0]):
            lab, xyz_b = labels[b], None if xyz is None else xyz[b]
            if xyz_b is not None:
                lab = filter_labels_depth(lab, xyz_b[..., 2], depth_threshold,
                                          max_label=ms.num_seeds)
            lab, k = renumber_labels_by_size(lab, ms.num_seeds)
            out.append(lab)
            counts.append(k)
            shifted = torch.where(lab > 0, lab + 1, 0)
            crops.append(crop_rois(image[b], shifted, xyz_b, max_instances=t.max_instances,
                                   crop_size=t.crop_size, padding=t.crop_padding))
        return UCNStage1(torch.stack(out), torch.stack(counts), crops)

    def _crop_labels(self, rgb, dep, first_seed_idx):
        """Crop-network features -> per-crop clustering -> labels shifted +1
        (background stays 0), so that match_label_crop sees values 0..T+1."""
        labels = self.cluster(self.network_crop(rgb, dep), first_seed_idx)
        return torch.where(labels > 0, labels + 1, 0)

    @torch.inference_mode()
    def refine(self, s1: UCNStage1, first_seed_idx=0) -> torch.Tensor:
        """Crop network on the present crops, then the paste-back -> [B, H, W]."""
        labels = s1.labels
        T, S = self.cfg.test.max_instances, self.cfg.test.crop_size
        present = torch.stack([c.present for c in s1.crops]).reshape(-1)     # [B*T]
        dropped = (s1.n_clusters - T).clamp_min(0).sum()
        host = torch.cat([present.int(), dropped.int().view(1)]).tolist()   # host sync
        if host[-1] > 0:
            print(f"WARNING: {host[-1]} cluster(s) beyond the {T} crop slots were not "
                  "refined (smallest by pixel count; raise test.max_instances to "
                  "refine them)")
        slots = [i for i, p in enumerate(host[:-1]) if p]
        if not slots:
            return labels
        idx = torch.tensor(slots, device=labels.device)
        rgb, dep = compact_crops(s1.crops, idx, T, S)
        labels_p = self._crop_labels(rgb, dep, first_seed_idx)
        return paste_back(labels, s1.crops, labels_p, idx, self.cfg.test)

    def __call__(self, image, xyz=None, depth_threshold: float = 0.8, refine: bool = True,
                 first_seed_idx=0):
        """-> (labels [B, H, W], refined [B, H, W]) int32."""
        s1 = self.stage1(image, xyz, depth_threshold=depth_threshold,
                         first_seed_idx=first_seed_idx)
        if not refine:
            return s1.labels, s1.labels
        return s1.labels, self.refine(s1, first_seed_idx)

    def stream(self, batches, depth_threshold: float = 0.8, first_seed_idx=0,
               depth: int = 2):
        """Software-pipelined inference over (image, xyz) batches, with the
        contract of ``TwoStagePredictor.stream``: stage 1 of the next
        ``depth`` batches is queued before each batch's one sync (the crop
        count and dropped clusters). Yields (labels, refined) in order."""
        yield from stream_batches(
            lambda b: self.stage1(*b, depth_threshold=depth_threshold,
                                  first_seed_idx=first_seed_idx),
            lambda s1: self.refine(s1, first_seed_idx), batches, depth)
