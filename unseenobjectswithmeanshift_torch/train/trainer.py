"""MSMFormer training: optimizer rules, the train step, the learning-rate schedule.

Port of ``unseenobjectswithmeanshift_tpu.train.trainer`` (:40-228; ref:
MSMFormer/tabletop_train_net_pretrained.py):

- AdamW, base lr 1e-4, weight decay 0.05; the backbone's parameters at
  lr x backbone_multiplier (0.1); the norm layers' parameters (BatchNorm,
  LayerNorm, GroupNorm) and the query / level embeddings without weight
  decay: JAX's path rule ``_is_norm_or_embed`` (:44-53), whose norm layers
  are the modules named ``*bn*`` / ``*norm*``, stated by module type.
- Full-model gradient clipping at global norm 0.01 as optax writes it:
  g / |g| * c where |g| >= c (scale c / max(|g|, c)); torch's
  ``clip_grad_norm_`` divides by |g| + 1e-6, which is not the same at
  c = 0.01.
- The optax chain clip -> Adam (eps 1e-8) -> masked decoupled decay ->
  -lr(step) -> backbone multiplier is one ``torch.optim.AdamW`` with a
  learning rate and a weight decay per parameter group: its update
  p (1 - lr_g wd_g) - lr_g m^/(sqrt(v^) + eps), with lr_g = lr * multiplier,
  is the chain's (tests/test_torch_train_optimizer.py holds it to optax).
- The schedule: base lr from step 0 (warmup_factor 1.0, every shipped
  config), else a linear warm-up over warmup_iters (:67-73).
- A non-finite loss or gradient keeps the parameters, the BatchNorm running
  statistics and the optimizer state, and reports skipped_nonfinite = 1
  (:186-200). Deciding it costs one host sync a step.

A step makes two host syncs: the criterion's one device-to-host copy of the
matching costs, and the finite check. Every random draw of a step comes
from a ``torch.Generator`` seeded by (seed, step), so a resumed run draws
what the uninterrupted one would have.

Both archs train: the UCN-backbone MSMFormer and the standard-backbone
StandardMaskFormer (ResNet50 or Swin, the JAX ``Trainer``'s ``build_model``,
:105-107). The ResNet50's BatchNorm is frozen (``FrozenBatchNorm2d``: no
parameter, no running-statistics update), where the JAX package trains it
on batch statistics (ROADMAP.md section 3). Data parallelism is not ported
(ROADMAP queue 1 item 13).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ..config import Config
from ..losses.criterion import CriterionDraws, SetCriterion
from ..losses.embedding import embedding_loss
from ..models.compute import BatchNorm2d, compute_dtype
from ..models.meta_arch import build_model, check_supported, is_standard
from ..weights import init_random

BACKBONE_PREFIXES = ("pretrained_backbone.", "backbone.")


def check_trainable(cfg: Config):
    """Raises ValueError for what the port does not train: a configuration
    it does not build, or the embedding loss on the standard arch, which has
    no embedding head (the JAX train step's error, trainer.py:157-165)."""
    check_supported(cfg)
    if is_standard(cfg) and cfg.loss.use_embedding_loss:
        raise ValueError(
            "loss.use_embedding_loss needs the meta-arch to expose backbone_features in its "
            "train outputs (the UCN-backbone MSMFormer does; the standard R50/Swin arch has no "
            f"embedding head to train it on); preset {cfg.name!r}")


NO_DECAY_MODULES = (nn.BatchNorm2d, nn.LayerNorm, nn.GroupNorm, nn.Embedding)


def no_decay_parameters(model: nn.Module):
    """ids of the parameters without weight decay: those of the norm layers
    (BatchNorm, LayerNorm, GroupNorm), the query_feat / query_embed tables
    and every ``level_embed`` (the decoder's table and the MSDeformAttn
    pixel decoder's parameter). These are the leaves JAX's
    ``_is_norm_or_embed`` picks by path (tests/test_torch_train_standard.py
    holds the groups to its label trees)."""
    return {id(p) for m in model.modules()
            for name, p in m.named_parameters(recurse=False)
            if isinstance(m, NO_DECAY_MODULES) or name == "level_embed"}


def make_optimizer(model: nn.Module, cfg: Config) -> torch.optim.AdamW:
    """AdamW with four parameter groups: backbone or not, decayed or not.
    Each group carries its ``multiplier`` of the scheduled lr."""
    s = cfg.solver
    skip = no_decay_parameters(model)
    groups: Dict[tuple, list] = {}
    for name, p in model.named_parameters():
        key = (name.startswith(BACKBONE_PREFIXES), id(p) in skip)
        groups.setdefault(key, []).append(p)
    return torch.optim.AdamW(
        [{"params": ps, "multiplier": s.backbone_multiplier if bb else 1.0,
          "weight_decay": 0.0 if nd else s.weight_decay}
         for (bb, nd), ps in sorted(groups.items())],
        lr=s.base_lr, betas=(0.9, 0.999), eps=1e-8)


def learning_rate(cfg: Config, step: int) -> float:
    """The schedule at a step (JAX make_optimizer :67-73): base_lr, or with
    warmup_factor < 1 a linear ramp from base_lr * warmup_factor over
    warmup_iters steps."""
    s = cfg.solver
    if s.warmup_factor >= 1.0:
        return s.base_lr
    t = min(step, max(s.warmup_iters, 1)) / max(s.warmup_iters, 1)
    init = s.base_lr * s.warmup_factor
    return init + (s.base_lr - init) * t


def clip_by_global_norm_(grads, norm, norm_value: float, max_norm: float):
    """In place, optax's clip_by_global_norm: g / |g| * max_norm where
    |g| >= max_norm, unchanged below. norm: |g| as a tensor on the grads'
    device; norm_value: the same on the host."""
    if norm_value >= max_norm:
        torch._foreach_div_(grads, norm)
        torch._foreach_mul_(grads, max_norm)


def pair_bucket(count: int, max_pairs: int, buckets=(16, 32, 48, 64, 96, 128, 192)) -> int:
    """Round a batch's instance count up to a pair-compaction bucket
    (max_pairs, no compaction, past every bucket)."""
    for b in buckets:
        if count <= b < max_pairs:
            return b
    return max_pairs


def new_model(cfg: Config, seed: int, device) -> nn.Module:
    """The configuration's MSMFormer with the JAX package's initializers,
    random from ``seed`` (a torch.Generator), on ``device``."""
    with torch.device("meta"):
        model = build_model(cfg)
    model = model.to_empty(device="cpu")
    init_random(model, torch.Generator().manual_seed(seed))
    return model.to(device)


class Trainer:
    """The model, criterion and optimizer of one training run. The
    constructor is the JAX ``Trainer.__init__`` and ``init_state`` together:
    the state (parameters, BatchNorm statistics, AdamW moments, step) lives
    in the model and the optimizer; ``state_dict`` / ``load_state_dict``
    carry it (``utils/checkpoint_io.py``)."""

    def __init__(self, cfg: Config, device="cuda", seed: int = 0,
                 model: Optional[nn.Module] = None):
        check_trainable(cfg)
        self.cfg, self.device, self.seed = cfg, torch.device(device), seed
        self.model = (model if model is not None else new_model(cfg, seed, device)).train()
        lc = cfg.loss
        self.criterion = SetCriterion(
            num_classes=cfg.decoder.num_classes, class_weight=lc.class_weight,
            mask_weight=lc.mask_weight, dice_weight=lc.dice_weight,
            eos_coef=lc.no_object_weight, num_points=lc.train_num_points,
            oversample_ratio=lc.oversample_ratio,
            importance_sample_ratio=lc.importance_sample_ratio,
            deep_supervision=lc.deep_supervision,
            # bf16 point sampling: the reference's AMP autocast around the
            # criterion (tabletop_train_net_pretrained.py:231-234)
            sample_dtype=torch.bfloat16 if compute_dtype(cfg.dtype) == torch.bfloat16 else None)
        self.optimizer = make_optimizer(self.model, cfg)
        self.step = 0

    def draws(self, batch: Dict, step: Optional[int] = None) -> CriterionDraws:
        """The criterion's draws of a step, from a generator seeded by (seed,
        step)."""
        step = self.step if step is None else step
        g = torch.Generator(device=self.device).manual_seed(self.seed * 1_000_003 + step)
        B, G = batch["gt_valid"].shape
        n_heads = 1 + (self.cfg.decoder.dec_layers if self.cfg.loss.deep_supervision else 0)
        return self.criterion.draw(n_heads, B, G, g, self.device)

    def loss(self, batch: Dict, draws: CriterionDraws, pair_budget=None):
        """(total, losses) of the train forward on a batch: image [B, H, W, 3],
        xyz or None, gt_labels [B, G], gt_masks [B, G, H, W], gt_valid [B, G]
        (valid slots first), and label_image [B, H, W] with the embedding
        loss."""
        outputs = self.model(batch["image"], batch.get("xyz"), train=True)
        total, losses = self.criterion(outputs, batch["gt_labels"], batch["gt_masks"],
                                       batch["gt_valid"], draws, pair_budget=pair_budget)
        lc = self.cfg.loss
        if lc.use_embedding_loss:
            # the metric-learning loss on the normalized backbone embedding
            # (ref: pretrained_meanshiftformer_model.py:316-325)
            emb, intra, inter = embedding_loss(
                outputs["backbone_features"].float(), batch["label_image"],
                k_max=lc.max_gt_instances + 1, alpha=lc.embedding_alpha,
                delta=lc.embedding_delta, lambda_intra=lc.embedding_lambda_intra,
                lambda_inter=lc.embedding_lambda_inter, normalize=lc.embedding_normalize)
            losses.update(embedding_loss=emb, intra_cluster_loss=intra,
                          inter_cluster_loss=inter)
            total = total + lc.embedding_loss_weight * emb
        return total, losses

    def gradients(self, batch: Dict, draws: Optional[CriterionDraws] = None, pair_budget=None):
        """Zero the gradients, run forward and backward: (total, losses),
        with the raw (unclipped) gradients in each parameter's .grad."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        total, losses = self.loss(batch, self.draws(batch) if draws is None else draws,
                                  pair_budget)
        total.backward()
        return total, losses

    def train_step(self, batch: Dict, draws: Optional[CriterionDraws] = None
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer step, the point-sampled pairs compacted to
        pair_bucket(the batch's instance count), as the JAX CLI does.
        Returns the metrics: every loss term, total_loss, grad_norm (before
        clipping) and skipped_nonfinite."""
        n_slots = batch["gt_valid"].numel()
        stats = {k: v.clone() for k, v in self.bn_buffers().items()}
        total, losses = self.gradients(batch, draws, lambda count: pair_bucket(count, n_slots))
        params = [p for g in self.optimizer.param_groups for p in g["params"]
                  if p.grad is not None]
        grads = [p.grad for p in params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        host = torch.stack([total.detach().float(), norm]).cpu()      # the step's host sync
        finite = bool(torch.isfinite(host).all())
        if finite:
            clip_by_global_norm_(grads, norm, float(host[1]), self.cfg.solver.clip_gradients)
            lr = learning_rate(self.cfg, self.step)
            for group in self.optimizer.param_groups:
                group["lr"] = lr * group["multiplier"]
            self.optimizer.step()
        else:
            with torch.no_grad():
                for k, v in self.bn_buffers().items():
                    v.copy_(stats[k])
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics.update(total_loss=total.detach(), grad_norm=host[1],
                       skipped_nonfinite=torch.tensor(0.0 if finite else 1.0))
        return metrics

    def bn_buffers(self) -> Dict[str, torch.Tensor]:
        """The BatchNorm running statistics (and batch counts), by name."""
        return {f"{n}.{b}": buf for n, m in self.model.named_modules()
                if isinstance(m, BatchNorm2d) for b, buf in m.named_buffers(recurse=False)}

    def state_dict(self) -> Dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: Dict):
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
