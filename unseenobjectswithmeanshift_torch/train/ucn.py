"""UCN (SEGNET) training with the metric-learning embedding loss.

Port of the train step of ``unseenobjectswithmeanshift_tpu.cli.train_net``
(:99-155; ref: tools/train_net.py + lib/fcn/train.py):

- the SEGNET of the configuration in train mode: BatchNorm on the batch
  statistics with flax's running-average rule (``models/compute.py``);
- ``losses/embedding.embedding_loss`` on the L2-normalized embeddings, with
  k_max = max_gt_instances + 1 cluster slots (background and instances) and
  the configuration's alpha, delta and weights;
- the optax chain ``add_decayed_weights(wd)`` then ``sgd(lr, momentum)`` as
  ``torch.optim.SGD(momentum, weight_decay)``: torch's d = g + wd p,
  buf = momentum buf + d (buf = d at the first step), p -= lr buf is optax's
  update, its trace starting from zeros (tests/test_torch_train_net.py holds
  the two equal over steps);
- the MultiStepLR schedule as optax's piecewise-constant one, with the JAX
  CLI's milestone shift on resume (:124-134): milestones at or before the
  start epoch fold into the initial lr, later ones fire at their absolute
  epoch. That is lr * gamma ** (milestones <= the absolute epoch).

A step is one forward and backward and one host sync (the loss terms).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn

from ..config import Config
from ..losses.embedding import embedding_loss
from ..models.segnet import build_segnet
from ..weights import init_random


def learning_rate(base_lr: float, milestones: Sequence[int], gamma: float, start_epoch: int,
                  steps_per_epoch: int, count: int) -> float:
    """The JAX CLI's schedule at optimizer step ``count`` of a run started at
    ``start_epoch``: optax.piecewise_constant_schedule(init, boundaries)."""
    lr = base_lr * gamma ** sum(1 for m in milestones if m <= start_epoch)
    for m in milestones:
        if m > start_epoch and count >= (m - start_epoch) * steps_per_epoch:
            lr *= gamma
    return lr


def new_segnet(cfg: Config, seed: int, device) -> nn.Module:
    """The configuration's SEGNET as two towers (the reference checkpoint
    layout) with the JAX package's initializers, random from ``seed``."""
    with torch.device("meta"):
        model = build_segnet(cfg, grouped_towers=False)
    model = model.to_empty(device="cpu")
    init_random(model, torch.Generator().manual_seed(seed))
    return model.to(device)


class UCNTrainer:
    """SEGNET, SGD optimizer and schedule of one UCN training run."""

    def __init__(self, cfg: Config, steps_per_epoch: int, lr: float = 1e-5,
                 momentum: float = 0.9, weight_decay: float = 1e-4, milestones=(),
                 gamma: float = 0.1, start_epoch: int = 0, device="cuda", seed: int = 0,
                 model: nn.Module = None):
        self.cfg, self.device = cfg, torch.device(device)
        self.model = (model if model is not None else new_segnet(cfg, seed, device)).train()
        self.optimizer = torch.optim.SGD(self.model.parameters(), lr=lr, momentum=momentum,
                                         weight_decay=weight_decay)
        self.base_lr, self.milestones, self.gamma = lr, list(milestones), gamma
        self.start_epoch, self.steps_per_epoch = start_epoch, steps_per_epoch
        self.count = 0                     # optimizer steps since this run started

    def lr(self) -> float:
        return learning_rate(self.base_lr, self.milestones, self.gamma, self.start_epoch,
                             self.steps_per_epoch, self.count)

    def loss(self, batch: Dict):
        """(loss, intra, inter) of the train forward on a batch: image
        [B, H, W, 3], xyz or None, label_image [B, H, W] int ({-1, 0..})."""
        feats = self.model(batch["image"], batch.get("xyz"))
        lc = self.cfg.loss
        return embedding_loss(feats.float(), batch["label_image"], k_max=lc.max_gt_instances + 1,
                              alpha=lc.embedding_alpha, delta=lc.embedding_delta,
                              lambda_intra=lc.embedding_lambda_intra,
                              lambda_inter=lc.embedding_lambda_inter)

    def train_step(self, batch: Dict) -> Dict[str, float]:
        """One SGD step -> {"loss", "loss_intra", "loss_inter", "lr"} (host floats)."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, intra, inter = self.loss(batch)
        loss.backward()
        lr = self.lr()
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1
        host = torch.stack([loss.detach(), intra.detach(), inter.detach()]).cpu()
        return {"loss": float(host[0]), "loss_intra": float(host[1]),
                "loss_inter": float(host[2]), "lr": lr}
