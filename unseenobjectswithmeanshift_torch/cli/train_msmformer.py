"""MSMFormer training CLI on synthetic tabletop scenes rendered on the card.

Port of ``unseenobjectswithmeanshift_tpu.cli.train_msmformer`` (ref:
MSMFormer/tabletop_train_net_pretrained.py: AdamW lr 1e-4, batch 4, backbone
lr x0.1, clip 0.01, deep supervision):

  python -m unseenobjectswithmeanshift_torch.cli.train_msmformer \\
      --dataset synthetic --iters 9000 --batch 4 --output out/ \\
      [--crop] [--bf16] [--embedding-loss] [--scene-style ocid] \\
      [--init-backbone ucn.pth] [--checkpoint-period N] [--log-period N] \\
      [--eval-period N --eval-samples 8]

--crop trains the 224x224 crop network (SYN_CROP: whole scenes rendered at
480x640, one object's padded square crop each). The run resumes from the
newest checkpoint_<step>.pth in --output when there is one (--fresh
ignores it) and appends {"kind": "train", "iter": ...} records to
<output>/metrics.jsonl every --log-period steps. With --eval-period N
(JAX ``cli/train_msmformer.py:148-200``; the reference's TEST.EVAL_PERIOD)
every N steps the network labels --eval-samples held-out clean scenes
(image_set "test", no augmentation, rendered once on the card) through
``stage1_labels``, scores them with ``multilabel_metrics``, prints the
metric block and appends a {"kind": "eval", "iter": ...} record. A checkpoint serves with
``build_two_stage_predictor(checkpoint=...)`` (the whole-image network) or
``checkpoint_crop=`` (the crop network).

Not ported yet, each refused with a ValueError naming its ROADMAP item: the
file-based datasets (--dataset tabletop_object, item 12) and training on
more than one card (item 13).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..config import get_config
from ..data.synthetic_device import SyntheticDeviceLoader
from ..pipeline.two_stage import stage1_labels
from ..train.trainer import Trainer
from ..utils import checkpoint_io
from ..utils.evaluation import aggregate_metrics, multilabel_metrics, print_metrics
from ..weights import load_reference_checkpoint


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", default="synthetic", choices=["synthetic", "tabletop_object"])
    p.add_argument("--root", default=None, help="dataset root (the file-based datasets)")
    p.add_argument("--scene-style", default="r4", choices=["r4", "ocid"])
    p.add_argument("--iters", type=int, default=71000)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--crop", action="store_true", help="train the 224x224 crop network")
    p.add_argument("--image-size", type=int, nargs=2, default=None, metavar=("H", "W"),
                   help="train at another size (default 224x224 with --crop, else 480x640)")
    p.add_argument("--bf16", action="store_true", help="compute in bf16 (fp32 parameters)")
    p.add_argument("--embedding-loss", action="store_true",
                   help="add the UCN metric-learning loss on the backbone embedding")
    p.add_argument("--init-backbone", default=None,
                   help="a reference UCN .pth to start the SEGNET backbone from")
    p.add_argument("--output", default="./output")
    p.add_argument("--fresh", action="store_true",
                   help="start at step 0 even if --output holds checkpoints")
    p.add_argument("--checkpoint-period", type=int, default=17500)
    p.add_argument("--log-period", type=int, default=20)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--devices", type=int, default=1, help="cards to train on (1)")
    p.add_argument("--eval-period", type=int, default=0,
                   help="score held-out clean scenes every N steps (0: never, as every "
                        "shipped config)")
    p.add_argument("--eval-samples", type=int, default=8)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def check_args(args):
    """Raises ValueError for what the port does not run yet."""
    if args.dataset != "synthetic":
        raise ValueError(f"--dataset {args.dataset}: the file-based dataset readers are not "
                         "ported (ROADMAP queue 1 item 12); use --dataset synthetic")
    if args.devices != 1:
        raise ValueError(f"--devices {args.devices}: data-parallel training is not ported "
                         "(ROADMAP queue 1 item 13)")


def image_hw(args):
    """The training size: --image-size, else 224x224 with --crop, else 480x640."""
    return tuple(args.image_size) if args.image_size else ((224, 224) if args.crop else (480, 640))


def build(args):
    """(trainer, loader) for the parsed flags."""
    cfg = get_config("crop_tabletop_pretrained" if args.crop else "tabletop_pretrained")
    cfg.solver.base_lr = args.lr
    cfg.loss.use_embedding_loss = cfg.loss.use_embedding_loss or args.embedding_loss
    cfg.dtype = "bfloat16" if args.bf16 else "float32"
    hw = image_hw(args)
    trainer = Trainer(cfg, device=args.device)
    if args.init_backbone:
        sd = {k if k.startswith("pretrained_backbone.") else "pretrained_backbone." + k: v
              for k, v in load_reference_checkpoint(args.init_backbone).items()
              if ".resnet34_8s." in k}
        missing = [k for k in trainer.model.state_dict()
                   if k.startswith("pretrained_backbone.") and k not in sd]
        if missing:
            raise ValueError(f"{args.init_backbone} lacks {len(missing)} backbone keys "
                             f"(first: {missing[0]})")
        trainer.model.load_state_dict(sd, strict=False)
        print(f"initialized the UCN backbone from {args.init_backbone}")
    loader = SyntheticDeviceLoader(
        args.batch, height=hw[0], width=hw[1], max_gt=cfg.loss.max_gt_instances,
        seed=0, syn_crop=args.crop, crop_size=hw[0], scene_style=args.scene_style,
        device=args.device)
    return trainer, loader


def eval_scenes(args, cfg, hw):
    """The held-out evaluation scenes, rendered once on the card: scene i of
    the "test" split, clean (no augmentation), as the JAX CLI renders them
    one at a time. -> [(image [1, H, W, 3], xyz [1, H, W, 3], label [H, W]
    int32 numpy)]."""
    vload = SyntheticDeviceLoader(
        1, height=hw[0], width=hw[1], max_gt=cfg.loss.max_gt_instances, image_set="test",
        seed=0, augment=False, syn_crop=args.crop, crop_size=hw[0],
        scene_style=args.scene_style, device=args.device)
    scenes = []
    for i in range(args.eval_samples):
        b = vload.batch_at(i)
        scenes.append((b["image"], b["xyz"], b["label_image"][0].cpu().numpy()))
    return scenes


def evaluate_scenes(model, cfg, scenes):
    """Stage-1 labels of each scene from the network in eval mode (running
    BatchNorm statistics), scored against its instances -> averaged metrics."""
    model.eval()
    metrics = []
    with torch.inference_mode():
        for image, xyz, label in scenes:
            out = model(image, xyz, light=True)
            per = {k: out[k][0] for k in ("pred_logits", "mask_embed", "mask_features")}
            lab, _ = stage1_labels(cfg, per, xyz[0], tuple(image.shape[1:3]))
            metrics.append(multilabel_metrics(lab.cpu().numpy(), label))
    model.train()
    return aggregate_metrics(metrics)


def main(argv=None):
    args = parse_args(argv)
    check_args(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trainer, loader = build(args)
    scenes = None
    if args.eval_period > 0:
        scenes = eval_scenes(args, trainer.cfg, image_hw(args))
    os.makedirs(args.output, exist_ok=True)
    latest = None if args.fresh else checkpoint_io.latest_checkpoint(args.output)
    if latest:
        checkpoint_io.restore(latest, trainer)
        print(f"resumed from {latest} (step {trainer.step})")
    log_path = os.path.join(args.output, "metrics.jsonl")
    t0 = time.perf_counter()
    while trainer.step < args.iters:
        # the scene stream is indexed by the step, so a resumed run sees the
        # batches the uninterrupted one would have
        metrics = trainer.train_step(loader.batch_at(trainer.step))
        it = trainer.step
        if it % args.log_period == 0:
            record = {k: float(v) for k, v in sorted(metrics.items())}
            with open(log_path, "a") as f:
                f.write(json.dumps({"kind": "train", "iter": it, **record}) + "\n")
            dt = (time.perf_counter() - t0) / args.log_period
            t0 = time.perf_counter()
            print(f"iter {it}/{args.iters} loss {record['total_loss']:.4f} ce "
                  f"{record['loss_ce']:.4f} mask {record['loss_mask']:.4f} dice "
                  f"{record['loss_dice']:.4f} skipped {record['skipped_nonfinite']:.0f} "
                  f"({dt:.3f} s/it)", flush=True)
        if scenes is not None and it % args.eval_period == 0:
            agg = evaluate_scenes(trainer.model, trainer.cfg, scenes)
            print(f"eval at iter {it} on {len(scenes)} held-out scenes:")
            print_metrics(agg)
            with open(log_path, "a") as f:
                f.write(json.dumps({"kind": "eval", "iter": it, **agg}) + "\n")
        if it % args.checkpoint_period == 0 or it == args.iters:
            path = checkpoint_io.save(checkpoint_io.checkpoint_path(args.output, it), trainer)
            print(f"saved {path}", flush=True)
    print("training done")


if __name__ == "__main__":
    main()
