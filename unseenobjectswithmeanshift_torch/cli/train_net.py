"""UCN backbone training CLI: the metric-learning embedding loss on TOD.

Port of ``unseenobjectswithmeanshift_tpu.cli.train_net`` (ref:
tools/train_net.py + lib/fcn/train.py: SGD momentum 0.9, lr 1e-5, batch 16,
16 epochs, MultiStepLR; per-iteration loss / intra / inter prints;
per-epoch snapshots seg_<infix>_epoch_N.checkpoint.pth):

  python -m unseenobjectswithmeanshift_torch.cli.train_net \\
      --root /path/to/tabletop --epochs 16 --batch 16 \\
      [--crop] [--input RGBD|COLOR|DEPTH] [--fusion add|cat|early] [--sampling] \\
      [--bf16] [--lr-milestones 8 12] [--pretrained X_epoch_4.checkpoint.pth \\
      --start-epoch 4] [--log-period 20] [--output DIR] [--device cuda]

  # file-free: tabletop scenes rendered on the card
  python -m unseenobjectswithmeanshift_torch.cli.train_net \\
      --dataset synthetic --epochs 4 --iters-per-epoch 500 --batch 16

--dataset tabletop_object reads the TOD training split through
``data/datasets.TableTopObject`` (augmentations on; SYN_CROP 224^2 crops
with --crop; pixel sampling with --sampling) and ``data/loader.BatchLoader``
(one producer thread, batches copied to the card from pinned memory); an
epoch is one pass, len(dataset) // batch steps. --dataset synthetic renders
--iters-per-epoch batches an epoch on the card
(``data/synthetic_device.SyntheticDeviceLoader``, batch i of the run at
step i).

After epoch N the network is written as
``<output>/<infix>_epoch_N.checkpoint.pth``, a plain SEGNET state_dict in the
reference's key layout: ``build_ucn_predictor(preset, checkpoint=path)``
serves it. Beside it, ``<infix>_epoch_N.optimizer.pth`` holds the SGD
momentum and the readers' random states. ``--pretrained`` continues from a
checkpoint (with its optimizer file when there is one) and ``--start-epoch``
numbers the epochs on: a run resumed at epoch e pulls the batches, draws and
learning rates an uninterrupted run pulls there. Each epoch takes exactly
``steps_per_epoch`` batches, ``zip(range(steps_per_epoch), loader)``: the
JAX CLI's ``enumerate(loader)`` ... ``break`` pulls one batch more an epoch
from the endless synthetic loader, so its resumed runs drift. Every
--log-period steps a {"kind": "train", "iter": ...} record goes to
``<output>/metrics.jsonl``; with --log-batches every step also writes a
{"kind": "batch", ...} record (file names, a checksum of the batch).

Not ported, refused with a ValueError naming its ROADMAP item: training on
more than one card (--devices above 1, item 13).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..config import get_config
from ..data.datasets import TableTopObject
from ..data.loader import BatchLoader, batch_checksum
from ..data.synthetic_device import SyntheticDeviceLoader
from ..train.ucn import UCNTrainer
from ..weights import load_reference_checkpoint


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=None, help="TOD root (--dataset tabletop_object)")
    p.add_argument("--dataset", default="tabletop_object",
                   choices=["tabletop_object", "synthetic"])
    p.add_argument("--iters-per-epoch", type=int, default=1000,
                   help="steps an epoch of the synthetic stream")
    p.add_argument("--scene-style", default="r4", choices=["r4", "ocid"])
    p.add_argument("--bf16", action="store_true", help="compute in bf16 (fp32 parameters)")
    p.add_argument("--epochs", type=int, default=16)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--lr-milestones", type=int, nargs="*", default=[])
    p.add_argument("--gamma", type=float, default=0.1)
    p.add_argument("--crop", action="store_true", help="train the 224x224 crop network")
    p.add_argument("--input", default="RGBD", choices=["RGBD", "COLOR", "DEPTH"])
    p.add_argument("--fusion", default="add", choices=["add", "cat", "early"])
    p.add_argument("--sampling", action="store_true",
                   help="per-cluster pixel sampling (EMBEDDING_SAMPLING)")
    p.add_argument("--output", default="./output_ucn")
    p.add_argument("--log-period", type=int, default=20)
    p.add_argument("--log-batches", action="store_true",
                   help="write each step's file names and batch checksum to metrics.jsonl")
    p.add_argument("--devices", type=int, default=1, help="cards to train on (1)")
    p.add_argument("--pretrained", default=None,
                   help="an <infix>_epoch_N.checkpoint.pth (or a reference UCN .pth) to "
                        "continue from")
    p.add_argument("--start-epoch", type=int, default=0,
                   help="epoch numbering offset when continuing")
    p.add_argument("--image-size", type=int, nargs=2, default=None, metavar=("H", "W"),
                   help="synthetic scenes at another size (default 224x224 with --crop, "
                        "else 480x640)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def check_args(args):
    """Raises ValueError for what the port does not run yet."""
    if args.devices != 1:
        raise ValueError(f"--devices {args.devices}: data-parallel training is not ported "
                         "(ROADMAP queue 1 item 13)")
    if args.dataset == "tabletop_object" and not args.root:
        raise ValueError("--root is required for --dataset tabletop_object")


def checkpoint_infix(args) -> str:
    """The reference's snapshot name (JAX cli/train_net.py:168-174)."""
    infix = f"seg_resnet34_8s_embedding_cosine_{args.input.lower()}"
    if args.input == "RGBD":
        infix += f"_{args.fusion}"
    if args.sampling:
        infix += "_sampling"
    if args.crop:
        infix += "_crop"
    return infix


def build_config(args):
    cfg = get_config("tabletop_pretrained")
    cfg.backbone.input_type = args.input
    cfg.backbone.fusion_type = args.fusion
    cfg.use_depth = args.input in ("RGBD", "DEPTH")
    cfg.input = args.input
    cfg.dtype = "bfloat16" if args.bf16 else "float32"
    return cfg


def build_data(args, cfg):
    """(loader, steps per epoch): the synthetic scene loader or the TOD
    reader's BatchLoader, batches on args.device."""
    if args.dataset == "synthetic":
        hw = tuple(args.image_size) if args.image_size else (
            (224, 224) if args.crop else (480, 640))
        loader = SyntheticDeviceLoader(
            args.batch, height=hw[0], width=hw[1], max_gt=cfg.loss.max_gt_instances,
            image_set="train", seed=0, syn_crop=args.crop, crop_size=hw[0],
            scene_style=args.scene_style, device=args.device)
        return loader, args.iters_per_epoch
    dataset = TableTopObject(args.root, "train", input_type=args.input, syn_crop=args.crop,
                             sampling=args.sampling, seed=0)
    loader = BatchLoader(dataset, args.batch, max_gt=cfg.loss.max_gt_instances,
                         seed=0, device=args.device, masks=False)
    steps = len(dataset) // args.batch
    if steps == 0:
        raise ValueError(f"{len(dataset)} samples under {args.root} make no batch of "
                         f"{args.batch}")
    return loader, steps


def epoch_batches(args, loader, steps, epoch):
    """The batches of one epoch: exactly ``steps`` of them."""
    if args.dataset == "synthetic":
        return (loader.batch_at(epoch * steps + i) for i in range(steps))
    return (b for _, b in zip(range(steps), loader))


def _rng_state(rng):
    name, keys, pos, has_gauss, gauss = rng.get_state()
    return {"keys": torch.from_numpy(keys.astype(np.int64)), "pos": int(pos),
            "has_gauss": int(has_gauss), "gauss": float(gauss)}


def _set_rng_state(rng, s):
    rng.set_state(("MT19937", s["keys"].numpy().astype(np.uint32), s["pos"], s["has_gauss"],
                   s["gauss"]))


def reader_states(args, loader):
    """The random states a file-based run carries from epoch to epoch."""
    if args.dataset == "synthetic":
        return {}
    return {"loader": _rng_state(loader.rng), "dataset": _rng_state(loader.dataset.rng)}


def save_epoch(args, trainer, loader, cfg, epoch: int) -> str:
    base = os.path.join(args.output, f"{checkpoint_infix(args)}_epoch_{epoch}")
    for path, state in ((base + ".checkpoint.pth", trainer.model.state_dict()),
                        (base + ".optimizer.pth", {
                            "optimizer": trainer.optimizer.state_dict(), "epoch": epoch,
                            "readers": reader_states(args, loader),
                            "config": json.dumps(dataclasses.asdict(cfg))})):
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)
    return base + ".checkpoint.pth"


def load_pretrained(args, trainer, loader):
    trainer.model.load_state_dict(load_reference_checkpoint(args.pretrained))
    opt = args.pretrained.replace(".checkpoint.pth", ".optimizer.pth")
    if opt != args.pretrained and os.path.exists(opt):
        state = torch.load(opt, map_location="cpu", weights_only=True)
        trainer.optimizer.load_state_dict(state["optimizer"])
        for name, rng in (("loader", getattr(loader, "rng", None)),
                          ("dataset", getattr(getattr(loader, "dataset", None), "rng", None))):
            if name in state["readers"] and rng is not None:
                _set_rng_state(rng, state["readers"][name])
        return opt
    return None


def main(argv=None):
    args = parse_args(argv)
    check_args(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = build_config(args)
    loader, steps = build_data(args, cfg)
    trainer = UCNTrainer(cfg, steps, lr=args.lr, momentum=args.momentum,
                         weight_decay=args.weight_decay, milestones=args.lr_milestones,
                         gamma=args.gamma, start_epoch=args.start_epoch, device=args.device)
    if args.pretrained:
        opt = load_pretrained(args, trainer, loader)
        print(f"continuing from {args.pretrained}" + (f" and {opt}" if opt else ""))
    os.makedirs(args.output, exist_ok=True)
    log_path = os.path.join(args.output, "metrics.jsonl")
    for epoch in range(args.start_epoch, args.epochs):
        t0 = time.perf_counter()
        for i, batch in enumerate(epoch_batches(args, loader, steps, epoch)):
            it = epoch * steps + i + 1
            if args.log_batches:
                names = batch.get("file_name", [])
                with open(log_path, "a") as f:
                    f.write(json.dumps({"kind": "batch", "epoch": epoch + 1, "iter": it,
                                        "files": [os.path.relpath(n, args.root or ".")
                                                  for n in names],
                                        "checksum": batch_checksum(batch)}) + "\n")
            m = trainer.train_step(batch)
            if (i + 1) % args.log_period == 0:
                dt = (time.perf_counter() - t0) / (i + 1)
                print(f"epoch {epoch + 1}/{args.epochs} iter {i + 1} loss {m['loss']:.4f} "
                      f"intra {m['loss_intra']:.4f} inter {m['loss_inter']:.4f} "
                      f"({dt:.3f} s/it)", flush=True)
                with open(log_path, "a") as f:
                    f.write(json.dumps({"kind": "train", "iter": it, "epoch": epoch + 1,
                                        **m}) + "\n")
        print(f"saved {save_epoch(args, trainer, loader, cfg, epoch + 1)}", flush=True)
    print("training done")


if __name__ == "__main__":
    main()
