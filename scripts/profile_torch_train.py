"""Where a train step of the PyTorch/CUDA port spends its time, on one NVIDIA GPU.

    python scripts/profile_torch_train.py [--preset P] [--crop] [--bf16] [--batch 4]
        [--steps 4]

Builds the full-width trainer of --preset (tabletop_pretrained by default;
any preset the port trains, the standard-backbone ones included), or of its
crop preset (pipeline.factory.crop_preset_for) with --crop, with random
weights from seed 0 and one batch from SyntheticDeviceLoader (B images at
480x640, or 224^2 SYN_CROP crops), then:

1. The step's parts on the host clock, each ending in torch.cuda.synchronize
   (median of --steps after two warm-ups): rendering the batch, the
   backbone's forward (SEGNET and pixel decoder; for a standard backbone
   the ResNet50 / Swin and the pixel decoder apart), the decoder's unfused
   forward, the criterion (of which the host LSAP), backward, the clip and
   optimizer update; and the whole train_step.
2. The same whole step with train_remat_attention off: every attention runs
   once in forward (the chunked cross-attention still checkpoints its chunks).
3. One step under torch.profiler: the device time by kernel name (its
   first 90 characters; top 15), the total device time and the profiled
   wall time (the idle share under the profiler's own overhead).

Prints the card's name and power limit first and one JSON line at the end.
Imports no JAX.
"""

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from unseenobjectswithmeanshift_torch.config import get_config
from unseenobjectswithmeanshift_torch.data.synthetic_device import SyntheticDeviceLoader
from unseenobjectswithmeanshift_torch.losses import matcher as matcher_module
from unseenobjectswithmeanshift_torch.models.meta_arch import is_standard
from unseenobjectswithmeanshift_torch.pipeline.factory import crop_preset_for
from unseenobjectswithmeanshift_torch.train.trainer import (
    Trainer, clip_by_global_norm_, learning_rate, pair_bucket,
)


def sync_ms(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


class LsapClock:
    """Wraps the criterion's host LSAP and sums its wall time."""

    def __init__(self):
        self.ms, self.inner = 0.0, matcher_module.solve_matches

    def __call__(self, *args):
        t = time.perf_counter()
        out = self.inner(*args)
        self.ms += (time.perf_counter() - t) * 1e3
        return out


def parts(tr, loader, batch):
    """One step split into its parts (ms)."""
    lsap = LsapClock()
    matcher_module.solve_matches = lsap
    try:
        _, render = sync_ms(lambda: loader.batch_at(0))
        tr.optimizer.zero_grad(set_to_none=True)
        draws = tr.draws(batch)
        split = {}
        if is_standard(tr.cfg):
            res, split["backbone_forward"] = sync_ms(
                lambda: tr.model.backbone_features(batch["image"]))
            (mfeats, _, ms), split["pixel_decoder_forward"] = sync_ms(
                lambda: tr.model.sem_seg_head.pixel_decoder(res))
            feats, mfeats = [m.permute(0, 2, 3, 1) for m in ms], mfeats.permute(0, 2, 3, 1)
            extra = {}
        else:
            (feats, mfeats), split["backbone_forward"] = sync_ms(
                lambda: tr.model.features(batch["image"], batch["xyz"]))
            extra = {"backbone_features": feats}
        outputs, decoder = sync_ms(lambda: tr.model.sem_seg_head.predictor.forward_unfused(
            feats, mfeats, remat=tr.cfg.train_remat_attention))
        outputs.update(mask_features=mfeats, **extra)
        n = batch["gt_valid"].numel()
        (total, _), crit = sync_ms(lambda: tr.criterion(
            outputs, batch["gt_labels"], batch["gt_masks"], batch["gt_valid"], draws,
            pair_budget=lambda c: pair_bucket(c, n)))
        _, backward = sync_ms(total.backward)

        def update():
            grads = [p.grad for p in tr.model.parameters() if p.grad is not None]
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            clip_by_global_norm_(grads, norm, float(norm), tr.cfg.solver.clip_gradients)
            for g in tr.optimizer.param_groups:
                g["lr"] = learning_rate(tr.cfg, 0) * g["multiplier"]
            tr.optimizer.step()

        _, optimizer = sync_ms(update)
    finally:
        matcher_module.solve_matches = lsap.inner
    return {"render": render, **split, "decoder_forward": decoder,
            "criterion": crit, "host_lsap": lsap.ms,
            "backward": backward, "optimizer": optimizer}


def step_ms(tr, batch, steps):
    for _ in range(2):
        tr.train_step(batch)
    return statistics.median(sync_ms(lambda: tr.train_step(batch))[1] for _ in range(steps))


def profile_step(tr, batch):
    from torch.profiler import ProfilerActivity, profile

    tr.train_step(batch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.train_step(batch)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    by_name = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA":
            name = e.key[:90]
            by_name[name] = by_name.get(name, 0.0) + e.self_device_time_total / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1 - busy / wall,
            "top_kernels_ms": dict(top)}


def main(argv=None):
    p = argparse.ArgumentParser(description="Where a train step of the port spends its time.")
    p.add_argument("--preset", default="tabletop_pretrained")
    p.add_argument("--crop", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--steps", type=int, default=4)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    cfg = get_config(crop_preset_for(args.preset) if args.crop else args.preset)
    cfg.dtype = "bfloat16" if args.bf16 else "float32"
    loader = SyntheticDeviceLoader(args.batch, max_gt=cfg.loss.max_gt_instances, seed=0,
                                   syn_crop=args.crop)
    batch = loader.batch_at(0)
    tr = Trainer(cfg, device="cuda", seed=0)
    step_ms(tr, batch, 1)
    split = [parts(tr, loader, batch) for _ in range(args.steps)]
    result = {"preset": cfg.name, "shape": list(batch["image"].shape), "dtype": cfg.dtype,
              "parts_ms": {k: statistics.median(s[k] for s in split) for k in split[0]},
              "step_ms": step_ms(tr, batch, args.steps)}
    cfg_nr = copy.deepcopy(cfg)
    cfg_nr.train_remat_attention = False
    tr_nr = Trainer(cfg_nr, device="cuda", seed=0)
    torch.cuda.reset_peak_memory_stats()
    result["step_ms_without_remat"] = step_ms(tr_nr, batch, args.steps)
    result["peak_gib_without_remat"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del tr_nr
    torch.cuda.empty_cache()
    result["profile"] = profile_step(tr, batch)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
