"""How well conditioned a standard-backbone train step is at seed-0 weights.

    python scripts/train_step_conditioning.py [--presets tabletop_swin uoais_resnet50]
        [--size 224 224]

For each preset (full width, random weights from seed 0, B=2 scenes from
SyntheticDeviceLoader at --size):

1. The train forward on the card against a CPU copy of the same weights,
   layer by layer: the backbone's res2..res5, each input projection of the
   MSDeformAttn pixel decoder before and after its GroupNorm (with the
   smallest std / |mean| of a GroupNorm group before it: how near constant
   the group is, which sets how much the GroupNorm amplifies rounding),
   each encoder layer, and every decoder head's mask embed: max |card -
   cpu| over max |cpu|.
2. The CPU against itself: one train step's loss terms and gradient norm
   with all the host's threads and with one thread (another summation
   order), relative deviation of each.

Without CUDA only part 2 runs. Prints the card's name and power limit
first (when there is a card) and one JSON line at the end. Imports no JAX.
"""

import argparse
import copy
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from unseenobjectswithmeanshift_torch.config import get_config
from unseenobjectswithmeanshift_torch.data.synthetic_device import SyntheticDeviceLoader
from unseenobjectswithmeanshift_torch.train.trainer import Trainer, new_model


def rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def record(model, image):
    """The train forward's intermediate tensors (float32, on the host)."""
    out, hooks = {}, []

    def keep(name):
        def hook(module, args, result):
            out[name] = (result if torch.is_tensor(result) else result[0]).detach().float().cpu()
        return hook

    pd = model.sem_seg_head.pixel_decoder
    for i, proj in enumerate(pd.input_proj):
        hooks.append(proj[0].register_forward_hook(keep(f"input_proj{i}.conv")))
        hooks.append(proj.register_forward_hook(keep(f"input_proj{i}.groupnorm")))
    for i, layer in enumerate(pd.transformer.encoder.layers):
        hooks.append(layer.register_forward_hook(keep(f"encoder{i}")))
    with torch.no_grad():
        for k, v in model.backbone_features(image).items():
            out[k] = v.float().cpu()
        result = model(image, train=True)
        for i, head in enumerate(result["aux_outputs"] + [result]):
            out[f"head{i}.mask_embed"] = head["mask_embed"].float().cpu()
    for h in hooks:
        h.remove()
    return out


def card_vs_cpu(cfg, hw):
    model = new_model(cfg, 0, "cuda")
    cpu = copy.deepcopy(model).cpu()
    image = SyntheticDeviceLoader(2, height=hw[0], width=hw[1], max_gt=cfg.loss.max_gt_instances,
                                  seed=0).batch_at(0)["image"]
    a, b = record(model, image), record(cpu, image.cpu())
    layers = {}
    for k in b:
        layers[k] = {"deviation": rel(a[k], b[k])}
        if k.endswith(".conv"):
            groups = b[k].reshape(b[k].shape[0], 32, -1)
            layers[k]["min_group_std_over_mean"] = (
                groups.std(-1) / groups.mean(-1).abs().clamp_min(1e-30)).min().item()
    return layers


def cpu_vs_itself(cfg, hw):
    batch = SyntheticDeviceLoader(2, height=hw[0], width=hw[1], max_gt=cfg.loss.max_gt_instances,
                                  seed=0, device="cpu").batch_at(0)
    base = new_model(cfg, 0, "cpu")
    threads = torch.get_num_threads()
    runs = []
    for n in (threads, 1):
        torch.set_num_threads(n)
        tr = Trainer(cfg, device="cpu", seed=0, model=copy.deepcopy(base))
        total, losses = tr.gradients(batch, tr.draws(batch))
        grads = [p.grad for p in tr.model.parameters() if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads])).item()
        runs.append(({k: float(v) for k, v in losses.items()}, float(total), norm))
    torch.set_num_threads(threads)
    (la, ta, na), (lb, tb, nb) = runs
    dev = {k: abs(la[k] - lb[k]) / max(abs(lb[k]), 1e-3) for k in lb}
    dev.update(total_loss=abs(ta - tb) / abs(tb), grad_norm=abs(na - nb) / nb)
    worst = max(dev, key=dev.get)
    return {"threads": [threads, 1], "worst_term": worst, "worst": dev[worst],
            "total_loss": dev["total_loss"], "grad_norm": dev["grad_norm"]}


def main(argv=None):
    p = argparse.ArgumentParser(description="Conditioning of a standard-backbone train step.")
    p.add_argument("--presets", nargs="+", default=["tabletop_swin", "uoais_resnet50"])
    p.add_argument("--size", nargs=2, type=int, default=[224, 224])
    args = p.parse_args(argv)
    card = torch.cuda.is_available()
    if card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    result = {}
    for preset in args.presets:
        cfg = get_config(preset)
        r = result[preset] = {"size": args.size}
        if card:
            r["card_vs_cpu"] = card_vs_cpu(cfg, args.size)
            for k, v in r["card_vs_cpu"].items():
                print(preset, k, " ".join(f"{n}={x:.3e}" for n, x in v.items()), flush=True)
        r["cpu_vs_itself"] = cpu_vs_itself(cfg, args.size)
        print(preset, "cpu vs itself", r["cpu_vs_itself"], flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
