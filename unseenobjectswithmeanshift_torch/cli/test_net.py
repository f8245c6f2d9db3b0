"""Full-dataset evaluation CLI: OCID / OSD / TOD test -> Objects & Boundary P/R/F.

Port of ``unseenobjectswithmeanshift_tpu.cli.test_net`` (ref:
tools/test_net.py + lib/fcn/test_demo.py, the documented reproduction path,
README.md:128-133): loop the dataset, run two-stage inference, score with
``multilabel_metrics``, print the metric block before and after refinement.

  python -m unseenobjectswithmeanshift_torch.cli.test_net \\
      --dataset ocid_object --root /path/to/OCID \\
      [--checkpoint msmformer.pth --checkpoint-crop msmformer_crop.pth] \\
      [--config PRESET] [--ucn] [--bf16] [--key-stride N] [--no-refine] \\
      [--batch 4] [--limit N] [--save-mat DIR] [--device cuda]

The flags are the JAX CLI's, plus --device (default cuda). The readers
decode and the metric counts in the port's native host library.
``evaluate`` is the loop: images go in batches of --batch through the
predictor's ``stream`` (stage 1 of the next batches is queued before each
batch's crop-count sync); the short last batch is padded by repeating its
last image and those outputs dropped; the ground truth comes from the same
read. Three host threads: a reader decodes the batches two ahead, the main
thread drives the card, a scorer scores each batch's labels.
"""

from __future__ import annotations

import argparse
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..data.datasets import get_dataset
from ..data.loader import pad_hw
from ..utils.evaluation import aggregate_metrics, multilabel_metrics, print_metrics, save_result_mat

# dataset -> default preset; the UOAIS datasets evaluate at the reference's
# DETECTIONS_PER_IMAGE 40 (ref: MSMFormer/configs/UOAIS_UCN.yaml:77)
DEFAULT_PRESET = {
    "ocid_object": "tabletop_pretrained",
    "osd_object": "tabletop_pretrained",
    "tabletop_object": "tabletop_pretrained",
    "ocid_object_uoais": "uoais_ucn",
    "osd_object_uoais": "uoais_ucn",
}


def predictor_device(pred) -> torch.device:
    net = pred.network if hasattr(pred, "network") else pred.model
    return next(net.parameters()).device


def _score(lab, ref, gt, mat, score):
    """The host's work on one image (on the worker thread): both label
    images scored, the .mat dump written. -> (metrics, refined metrics,
    seconds)."""
    t0 = time.perf_counter()
    m = mr = None
    if score:
        m = multilabel_metrics(lab, gt)
        mr = multilabel_metrics(ref, gt)
    if mat is not None:
        save_result_mat(mat[0], lab, ref, filename=mat[1])
    return m, mr, time.perf_counter() - t0


def evaluate(pred, dataset, batch: int = 4, osd: bool = False, refine: bool = True,
             ucn_threshold=None, save_mat=None, limit: int = 0, score: bool = True,
             keep_labels: bool = True, name: str = "dataset", log=print):
    """Run ``pred`` (a TwoStagePredictor, or a UCNPredictor when
    ucn_threshold, its depth-filter threshold, is given) over the first
    ``limit`` images of ``dataset`` (all with 0) in batches of ``batch``,
    and score each image's stage-1 and refined labels against its ground
    truth with ``multilabel_metrics``. save_mat: a directory
    for per-image .mat dumps. score=False runs the card alone.

    Returns {"metrics", "metrics_refined": per-image dicts (empty without
    score), "labels", "refined", "gt": the [h, w] int32 label images scored
    (empty without keep_labels), "file_names", "batches": the images of
    each batch before its padding, "timing": {images, wall_s, img_per_s,
    read_ms_per_image (the reader thread's seconds over the images),
    read_wait_s (the main thread's wait for the reader), metric_ms_per_image
    (the scoring thread's seconds: both label images scored and the .mat
    written, over the images), metric_wait_s (the wait for the scoring
    thread after the card's last batch)}}."""
    n = min(len(dataset), limit) if limit else len(dataset)
    if n == 0:
        raise ValueError(f"no images to evaluate in {name}")
    B = max(1, batch)
    device = predictor_device(pred)
    meta, read = [], {"s": 0.0, "wait_s": 0.0}

    def read_batch(start):
        """One host batch (on the reader thread): the samples, the short
        last batch padded with its last image, stacked and padded."""
        t0 = time.perf_counter()
        samples = [dataset[i] for i in range(start, min(start + B, n))]
        count = len(samples)
        samples += [samples[-1]] * (B - count)
        img = np.stack([pad_hw(s["image"]) for s in samples])
        xyz = (None if samples[0].get("xyz") is None
               else np.stack([pad_hw(s["xyz"]) for s in samples]))
        # the labels of this read are the ground truth: no second decode
        return (count, [s["label"] for s in samples[:count]],
                [s["file_name"] for s in samples[:count]], img, xyz, time.perf_counter() - t0)

    def batches():
        """The device batches, each read on a thread two batches ahead."""
        starts = list(range(0, n, B))
        with ThreadPoolExecutor(max_workers=1) as reader:
            ahead = deque(reader.submit(read_batch, s) for s in starts[:2])
            for k in range(len(starts)):
                t0 = time.perf_counter()
                count, labels, names, img, xyz, dt = ahead.popleft().result()
                read["wait_s"] += time.perf_counter() - t0
                read["s"] += dt
                if k + 2 < len(starts):
                    ahead.append(reader.submit(read_batch, starts[k + 2]))
                meta.append((count, labels, names))
                yield (torch.from_numpy(img).to(device),
                       None if xyz is None else torch.from_numpy(xyz).to(device))

    if ucn_threshold is not None:
        run = (pred.stream(batches(), depth_threshold=ucn_threshold) if refine else
               (pred(img, xyz, depth_threshold=ucn_threshold, refine=False)
                for img, xyz in batches()))
    else:
        run = (pred.stream(batches(), osd=osd) if refine else
               (pred(img, xyz, osd=osd, refine=False) for img, xyz in batches()))
    if save_mat:
        os.makedirs(save_mat, exist_ok=True)
    out = {"labels": [], "refined": [], "gt": [], "file_names": [], "batches": []}
    jobs = []
    t_start = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        done = 0
        for bi, (labels, refined) in enumerate(run):
            count, gt_list, names = meta[bi]
            labels, refined = labels.cpu().numpy(), refined.cpu().numpy()
            out["batches"].append(count)
            for j in range(count):
                i = bi * B + j
                gt = gt_list[j]
                h, w = gt.shape
                lab, ref = labels[j, :h, :w], refined[j, :h, :w]
                out["file_names"].append(names[j])
                if keep_labels:
                    out["labels"].append(lab)
                    out["refined"].append(ref)
                    out["gt"].append(gt)
                mat = (None if not save_mat else
                       (os.path.join(save_mat, f"{i:06d}.mat"), f"{name}/{i:06d}"))
                if score or mat:
                    jobs.append(pool.submit(_score, lab, ref, gt, mat, score))
            done += count
            if done % (50 // B * B or B) < count:
                dt = (time.perf_counter() - t_start) / done
                log(f"[{done}/{n}] {dt:.3f}s/img (est. full pass {dt * n / 60:.1f} min)")
        t_card = time.perf_counter()
        results = [j.result() for j in jobs]
    wall = time.perf_counter() - t_start
    out["metrics"] = [r[0] for r in results] if score else []
    out["metrics_refined"] = [r[1] for r in results] if score else []
    out["timing"] = {
        "images": n, "wall_s": wall, "img_per_s": n / wall,
        "read_ms_per_image": read["s"] / n * 1e3, "read_wait_s": read["wait_s"],
        "metric_ms_per_image": sum(r[2] for r in results) / n * 1e3,
        "metric_wait_s": time.perf_counter() - t_card,
    }
    return out


def report(result) -> None:
    """The JAX CLI's metric block: the pass, then the stage-1 and refined
    averages."""
    t = result["timing"]
    print("=" * 56)
    print(f"{t['images']} images in {t['wall_s']:.1f}s ({t['img_per_s']:.2f} img/s incl. "
          f"host metrics; host metrics {t['metric_ms_per_image']:.1f} ms/img, read "
          f"{t['read_ms_per_image']:.1f} ms/img)")
    print("=" * 56)
    print_metrics(aggregate_metrics(result["metrics"]))
    print("=" * 20 + " Refined " + "=" * 27)
    print_metrics(aggregate_metrics(result["metrics_refined"]))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="ocid_object", choices=sorted(DEFAULT_PRESET))
    p.add_argument("--root", required=True)
    p.add_argument("--config", default=None,
                   help="config preset for the whole-image network "
                        "(default: per-dataset; see DEFAULT_PRESET)")
    p.add_argument("--crop-config", default=None,
                   help="preset for the crop network (default: paired preset)")
    p.add_argument("--checkpoint", default=None, help="reference .pth or exported .npz")
    p.add_argument("--checkpoint-crop", default=None)
    p.add_argument("--ucn", action="store_true", help="legacy UCN pipeline")
    p.add_argument("--no-refine", action="store_true")
    p.add_argument("--no-depth", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--key-stride", type=int, default=1,
                   help="opt-in fast serving: subsample attention keys "
                        "(NOT the parity configuration)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--save-mat", default=None,
                   help="directory for per-image .mat result dumps")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    ds_kwargs = {"input_type": "COLOR" if args.no_depth else "RGBD"}
    if args.dataset == "tabletop_object":
        ds_kwargs.update(image_set="test", use_augmentation=False, chromatic=False,
                         add_noise=False)
    dataset = get_dataset(args.dataset, args.root, **ds_kwargs)
    n = min(len(dataset), args.limit) if args.limit else len(dataset)
    print(f"{n} images from {args.dataset}, batch {max(1, args.batch)}")

    preset = args.config or DEFAULT_PRESET[args.dataset]
    osd = args.dataset.startswith("osd_object")
    if not args.checkpoint:
        print("WARNING: random weights")
    thr = None
    if args.ucn:
        if args.key_stride > 1:
            p.error("--key-stride applies to the MSMFormer decoder; the UCN "
                    "pipeline has no attention keys to stride")
        from ..pipeline.factory import build_ucn_predictor

        # the crop SEGNET takes the same preset unless --crop-config says
        # otherwise, as the JAX CLI builds it
        pred = build_ucn_predictor(preset, crop_preset=args.crop_config or preset,
                                   checkpoint=args.checkpoint,
                                   checkpoint_crop=args.checkpoint_crop, bf16=args.bf16,
                                   no_depth=args.no_depth, device=args.device)
        t = pred.cfg.test
        thr = t.depth_filter_threshold_osd if osd else t.depth_filter_threshold_ocid
    else:
        from ..pipeline.factory import build_two_stage_predictor

        pred = build_two_stage_predictor(preset, crop_preset=args.crop_config,
                                         checkpoint=args.checkpoint,
                                         checkpoint_crop=args.checkpoint_crop, bf16=args.bf16,
                                         no_depth=args.no_depth, key_stride=args.key_stride,
                                         device=args.device)
    result = evaluate(pred, dataset, batch=args.batch, osd=osd, refine=not args.no_refine,
                      ucn_threshold=thr, save_mat=args.save_mat, limit=args.limit,
                      keep_labels=False, name=args.dataset)
    report(result)
    return result


if __name__ == "__main__":
    main()
