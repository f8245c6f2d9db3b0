"""Shared small cases for the training parity tests (tests/test_torch_train_*.py).

Hidden 32, 4 heads, 6 queries, 2 decoder layers, mask_dim 32, 16-d
embeddings on the full ResNet34-8s towers, 32x48 images, 3 gt slots with 2
instances, 64 matcher points. ``jax_draws`` reproduces the JAX criterion's
key splits (criterion.py:82, matcher.py:17/:31, point_sample.py) so that the
port's criterion gets the JAX package's own random draws.
"""

import jax
import numpy as np
import torch

from unseenobjectswithmeanshift_tpu.config import get_config as jax_get_config
from unseenobjectswithmeanshift_torch.config import get_config
from unseenobjectswithmeanshift_torch.losses.criterion import CriterionDraws
from torch_threads import few_torch_threads  # noqa: F401  (re-exported)

H, W, B, G = 32, 48, 2, 3


def _shrink(cfg, input_type):
    d = cfg.decoder
    d.num_queries, d.hidden_dim, d.dim_feedforward, d.dec_layers = 6, 32, 32, 2
    d.nheads, d.mask_dim, d.conv_dim = 4, 32, 16
    cfg.backbone.num_units = 16
    cfg.pixel_decoder.conv_dim, cfg.pixel_decoder.mask_dim = 16, 32
    cfg.loss.train_num_points, cfg.loss.max_gt_instances = 64, G
    if input_type == "COLOR":
        cfg.backbone.input_type, cfg.input, cfg.use_depth = "COLOR", "COLOR", False
    return cfg


def tiny_configs(input_type="RGBD"):
    """(JAX config, port config) of the tiny training case."""
    return (_shrink(jax_get_config("tabletop_pretrained"), input_type),
            _shrink(get_config("tabletop_pretrained"), input_type))


def tiny_batch(seed=0, use_depth=True):
    """numpy batch: 2 instances in the first 2 of 3 slots, and the label
    image (slot i -> label i + 1, background 0)."""
    rng = np.random.RandomState(seed)
    masks = np.zeros((B, G, H, W), np.float32)
    masks[:, 0, 4:16, 4:20] = 1
    masks[:, 1, 18:30, 22:44] = 1
    masks[1, 1, 18:24] = 0
    label = (masks[:, 0] + 2 * masks[:, 1]).astype(np.int32)
    batch = {"image": rng.rand(B, H, W, 3).astype(np.float32) - 0.4,
             "gt_labels": np.ones((B, G), np.int32), "gt_masks": masks,
             "gt_valid": np.tile([True, True, False], (B, 1)), "label_image": label}
    if use_depth:
        batch["xyz"] = (rng.rand(B, H, W, 3) * 1.5).astype(np.float32)
    return batch


def to_torch(batch, device="cpu"):
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in batch.items()}


def jax_draws(rng, n_heads, batch_size, n_slots, num_points, oversample_ratio=3.0,
              importance_sample_ratio=0.75):
    """The JAX SetCriterion's draws for key ``rng`` as the port's
    CriterionDraws (fp32 CPU tensors)."""
    num_sampled = int(num_points * oversample_ratio)
    num_uncertain = int(importance_sample_ratio * num_points)
    pts, coords, rand = [], [], []
    t = lambda a: torch.from_numpy(np.asarray(a))
    for _ in range(n_heads):
        rng, k_match, k_pts = jax.random.split(rng, 3)
        keys = jax.random.split(k_match, batch_size)
        pts.append(t(np.concatenate([jax.random.uniform(k, (1, num_points, 2)) for k in keys])))
        k1, k2 = jax.random.split(k_pts)
        coords.append(t(jax.random.uniform(k1, (n_slots, num_sampled, 2))))
        rand.append(t(jax.random.uniform(k2, (n_slots, num_points - num_uncertain, 2))))
    return CriterionDraws(pts, coords, rand)


def tree_items(tree, prefix=()):
    """Flat {path tuple: numpy leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(tree_items(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def scaled_diff(a, b):
    """max |a - b| over max |b| (0 when both are 0)."""
    scale = float(np.abs(b).max())
    return float(np.abs(np.asarray(a) - b).max()) / (scale if scale > 0 else 1.0)

