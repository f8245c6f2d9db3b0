"""Where a dataset evaluation pass of the PyTorch/CUDA port spends its time,
on one NVIDIA GPU.

    python scripts/profile_torch_eval.py [--frames 64]

Writes an OCID-layout tree of --frames frames rendered on the card
(``chip_smoke.write_eval_trees``: PNG colour and paletted labels,
binary_compressed clouds, 480x640), then, for MSMFormer fp32, MSMFormer bf16
and UCN (chip_smoke's decisive predictors, B=4):

1. ``cli.test_net.evaluate`` as the CLI runs it (a reader thread, the card's
   thread, a scoring thread): img/s, and the reader's and the scorer's
   seconds on their threads;
2. the same with score=False (no scoring thread): img/s;
3. the predictor alone: every batch read and copied to the card first, then
   ``stream`` over them with each batch's labels copied back, as the card's
   thread does in 1: img/s;
4. 3. under torch.profiler: the device's busy ms a frame (the kernels,
   copies and fills it ran) and its idle share;
5. the scoring alone on one thread: ``multilabel_metrics`` of the two label
   images of each frame that 1. scored, ms a frame.

Once, before them: the reader alone on one thread, ms a frame split into
the colour PNG, the label PNG (with the table removal and remapping), the
cloud and the colour normalization.

Prints one JSON line at the end. Imports no JAX.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from unseenobjectswithmeanshift_torch.cli.test_net import evaluate
from unseenobjectswithmeanshift_torch.data.datasets import get_dataset, normalize_bgr, remap_labels
from unseenobjectswithmeanshift_torch.data.loader import pad_hw
from unseenobjectswithmeanshift_torch.data.pcd import read_pcd_xyz
from unseenobjectswithmeanshift_torch.ops import _build
from unseenobjectswithmeanshift_torch.utils.evaluation import multilabel_metrics
from unseenobjectswithmeanshift_torch.utils.image_io import imread, imread_indexed

B = 4


def reader_parts(dataset):
    """The OCID reader's steps for every frame, timed one by one on this
    thread -> {part: ms a frame}, with the whole ``dataset[i]`` beside."""
    parts = {"colour_png": [], "label_png": [], "cloud": [], "normalize": [], "whole": []}
    for i, filename in enumerate(dataset.image_paths):
        t0 = time.perf_counter()
        im = imread(filename)
        t1 = time.perf_counter()
        label = imread_indexed(filename.replace("rgb", "label"))
        label[label == 1] = 0
        if "table" in filename:
            label[label == 2] = 0
        remap_labels(label)
        t2 = time.perf_counter()
        read_pcd_xyz(filename.replace("rgb", "pcd").replace(".png", ".pcd"))
        t3 = time.perf_counter()
        normalize_bgr(im)
        t4 = time.perf_counter()
        dataset[i]
        t5 = time.perf_counter()
        for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
            parts[k].append(dt * 1e3)
    return {k: statistics.mean(v) for k, v in parts.items()}


def device_busy_ms(prof):
    """The summed device time of the events that ran on the GPU."""
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3


def card_batches(dataset):
    """Every batch of the pass read, padded as evaluate pads it, on the card."""
    out = []
    for start in range(0, len(dataset), B):
        samples = [dataset[i] for i in range(start, min(start + B, len(dataset)))]
        samples += [samples[-1]] * (B - len(samples))
        img = np.stack([pad_hw(s["image"]) for s in samples])
        xyz = np.stack([pad_hw(s["xyz"]) for s in samples])
        out.append((torch.from_numpy(img).cuda(), torch.from_numpy(xyz).cuda()))
    return out


def profile_predictor(tag, pred, dataset, thr=None):
    """1-5 for one predictor -> result dict."""
    n = len(dataset)
    run = lambda **kw: evaluate(pred, dataset, batch=B, ucn_threshold=thr, log=lambda s: None,
                                **kw)
    run(keep_labels=False)                                     # warm: autotune, allocator
    full = run()
    t = full["timing"]
    no_score = run(score=False, keep_labels=False)["timing"]
    batches = card_batches(dataset)
    kw = {"depth_threshold": thr} if thr is not None else {}

    def card_pass():
        for labels, refined in pred.stream(iter(batches), **kw):
            labels.cpu(), refined.cpu()

    card_pass()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_pass()
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        card_pass()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    busy = device_busy_ms(prof)
    score_ms = []
    for lab, ref, gt in zip(full["labels"], full["refined"], full["gt"]):
        t0 = time.perf_counter()
        multilabel_metrics(lab, gt)
        multilabel_metrics(ref, gt)
        score_ms.append((time.perf_counter() - t0) * 1e3)
    res = {
        "images": n,
        "img_per_s": t["img_per_s"],
        "img_per_s_without_scorer": no_score["img_per_s"],
        "img_per_s_predictor_alone": n / card_s,
        "reader_thread_ms_per_image": t["read_ms_per_image"],
        "scorer_thread_ms_per_image": t["metric_ms_per_image"],
        "card_thread_read_wait_s": t["read_wait_s"],
        "device_busy_ms_per_image": busy / n,
        "traced_wall_ms_per_image": traced_s * 1e3 / n,
        "device_idle_share": max(0.0, 1 - busy / (traced_s * 1e3)),
        "scoring_alone_ms_per_image": statistics.mean(score_ms),
        "objects_detected_per_image": statistics.mean(m["obj_detected"]
                                                      for m in full["metrics"]),
    }
    print(f"{tag}: {res['img_per_s']:.2f} img/s as the CLI runs, "
          f"{res['img_per_s_without_scorer']:.2f} without the scorer thread, "
          f"{res['img_per_s_predictor_alone']:.2f} the predictor alone; device busy "
          f"{res['device_busy_ms_per_image']:.1f} ms a frame of "
          f"{res['traced_wall_ms_per_image']:.1f} traced (idle share "
          f"{res['device_idle_share']:.2f}); reader thread "
          f"{res['reader_thread_ms_per_image']:.1f} ms a frame, scorer thread "
          f"{res['scorer_thread_ms_per_image']:.1f}, scoring alone "
          f"{res['scoring_alone_ms_per_image']:.1f}", flush=True)
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description="Where an evaluation pass spends its time.")
    p.add_argument("--frames", type=int, default=64, help="OCID frames to write (a multiple "
                   "of 4 keeps every batch full)")
    opts = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.build_all()
    result = {"device": torch.cuda.get_device_name(0), "card": card, "frames": opts.frames,
              "batch": B}
    d = tempfile.mkdtemp(prefix="uoms_eval_")
    while "rgb" in d or "table" in d:      # the OCID reader replaces / tests these words
        os.rmdir(d)
        d = tempfile.mkdtemp(prefix="uoms_eval_")
    try:
        chip_smoke.OCID_FRAMES, chip_smoke.OSD_FRAMES = opts.frames, 0
        ocid_root, _, _ = chip_smoke.write_eval_trees(d)
        ocid = get_dataset("ocid_object", ocid_root)
        reader_parts(ocid)                                       # warm: page cache, library
        result["reader_alone_ms_per_image"] = reader_parts(ocid)
        print(f"reader alone, ms a frame: {result['reader_alone_ms_per_image']}", flush=True)
        pred = chip_smoke.decisive_predictor(seed=0)
        result["msmformer_fp32"] = profile_predictor("msmformer fp32", pred, ocid)
        del pred
        pred = chip_smoke.decisive_predictor(seed=0, bf16=True)
        result["msmformer_bf16"] = profile_predictor("msmformer bf16", pred, ocid)
        del pred
        torch.cuda.empty_cache()
        s = ocid[0]
        ucn = chip_smoke.decisive_ucn_predictor(torch.from_numpy(s["image"][None]).cuda(),
                                                torch.from_numpy(s["xyz"][None]).cuda(), seed=0)
        result["ucn"] = profile_predictor("ucn", ucn, ocid,
                                          thr=ucn.cfg.test.depth_filter_threshold_ocid)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
