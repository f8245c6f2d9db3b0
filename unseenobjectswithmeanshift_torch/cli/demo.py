"""Demo CLI: two-stage MSMFormer inference on a folder of RGB(-D) images.

Port of ``unseenobjectswithmeanshift_tpu.cli.demo`` (ref:
tools/test_image_with_ms_transformer.py:150-218): glob '*color*' / '*depth*'
images plus camera_params.json, build the whole-image and crop predictors,
run two-stage inference per image and save '-label.png' outputs.

  python -m unseenobjectswithmeanshift_torch.cli.demo --imgdir DIR \\
      [--checkpoint msmformer.pth --checkpoint-crop msmformer_crop.pth] \\
      [--config PRESET] [--no-depth] [--key-stride 2] [--bf16] [--out DIR] [--device cuda]

The flags are the JAX demo's, plus --device (default cuda) and --preset (the
same as --config). A checkpoint is a
reference .pth or an .npz written by scripts/export_release_npz.py; without
one the networks have random weights (a pipeline smoke run). Images are
read and the label PNGs written by ``utils/image_io`` (PNG and JPEG without
cv2, which the card machine lacks).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np
import torch

from ..pipeline.factory import build_two_stage_predictor
from ..utils.image_io import write_png
from ..utils.preprocess import fov_intrinsics, pad_to_multiple, read_sample


def build_predictor(args):
    """(predictor, whole-image config) for the parsed flags."""
    preset = args.config or ("tabletop_pretrained" if not args.no_depth
                             else "tabletop_pretrained_rgb")
    if not args.checkpoint:
        print("WARNING: no checkpoint given - running with random weights")
    pred = build_two_stage_predictor(
        preset, checkpoint=args.checkpoint, checkpoint_crop=args.checkpoint_crop,
        bf16=args.bf16, no_depth=args.no_depth, key_stride=args.key_stride,
        device=args.device)
    return pred, pred.cfg


def label_frame(pred, image, xyz=None, refine: bool = True):
    """One frame through the predictor: image [H, W, 3] normalized BGR and
    xyz [H, W, 3] or None, tensors on the predictor's device, padded to a
    multiple of 32 as the JAX demo pads them. -> (refined labels [Hp, Wp]
    int32 numpy, host ms of the call)."""
    img, _ = pad_to_multiple(image[None], 32)
    if xyz is not None:
        xyz, _ = pad_to_multiple(xyz[None], 32)
    t0 = time.perf_counter()
    _, refined = pred(img, xyz, refine=refine)
    refined = refined[0].cpu().numpy()          # syncs
    return refined, (time.perf_counter() - t0) * 1e3


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--imgdir", required=True)
    p.add_argument("--config", "--preset", dest="config", default=None,
                   help="config preset (tabletop_pretrained, uoais_ucn, mixture_ucn, "
                        "tabletop_pretrained_resnet50, tabletop_swin, ...); default picks "
                        "the flagship UCN-backbone preset")
    p.add_argument("--checkpoint", default=None, help="reference .pth or exported .npz")
    p.add_argument("--checkpoint-crop", default=None)
    p.add_argument("--camera-params", default=None)
    p.add_argument("--no-depth", action="store_true")
    p.add_argument("--no-refine", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="compute in bf16 (the JAX package's serving dtype)")
    p.add_argument("--key-stride", type=int, default=1,
                   help="opt-in fast serving: subsample attention keys "
                        "(NOT the parity configuration)")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--out", default=None, help="directory for -label.png outputs")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    # fp32 runs without TF32, bf16 accumulates its products in fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    color_files = sorted(glob.glob(os.path.join(args.imgdir, "*color*")))
    depth_files = sorted(glob.glob(os.path.join(args.imgdir, "*depth*")))
    params_file = args.camera_params or os.path.join(args.imgdir, "camera_params.json")
    camera_params = None
    if os.path.exists(params_file):
        with open(params_file) as f:
            camera_params = json.load(f)
    elif depth_files and not args.no_depth:
        # as the JAX demo: the TOD synthetic camera instead of the reference's crash
        camera_params = fov_intrinsics(args.width, args.height)
        print(f"WARNING: no {params_file}; using default FOV intrinsics "
              f"(fx=fy={camera_params['fx']:.1f})")

    pred, cfg = build_predictor(args)
    input_type = "RGBD" if cfg.use_depth else "COLOR"
    out_dir = args.out or args.imgdir
    os.makedirs(out_dir, exist_ok=True)
    for i, cf in enumerate(color_files):
        df = depth_files[i] if i < len(depth_files) else None
        sample = read_sample(cf, df, camera_params, input_type=input_type, device=args.device)
        refined, ms = label_frame(pred, sample["image"], sample["xyz"],
                                  refine=not args.no_refine)
        print(f"{os.path.basename(cf)}: {ms:.1f} ms, {len(np.unique(refined)) - 1} instances")
        # binary label image (ref: get_network_crop.py save_data)
        label_save = (np.clip(refined, 0, 1) * 255).astype(np.uint8)
        write_png(os.path.join(out_dir, os.path.basename(cf)[:-4] + "-label.png"), label_save)
    print("done")


if __name__ == "__main__":
    main()
