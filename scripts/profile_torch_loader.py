#!/usr/bin/env python3
"""Where the TOD training loader's time goes, on the card machine.

    python3 scripts/profile_torch_loader.py [--scenes 8] [--batch 16]

Writes a TOD tree of rendered 480x640 scenes (chip_smoke.write_tod_tree:
JPEG colour, PNG depth and labels), then times, over one pass of the
training split with every augmentation on (seed 0):

1. ``TableTopObject[i]`` on the main thread, ms a sample;
2. ``BatchLoader`` synchronous (prefetch 0) and on its producer thread
   (prefetch 2), numpy batches and batches copied to the card from pinned
   memory, ms a sample read (the pass reads every sample; the last partial
   batch is dropped);
3. one synchronous pass under cProfile (the reader, collate and pinning by
   function);
4. a UCN train step alone (B=16, fp32, one batch) and train_net's epoch
   loop (the loader's producer thread beside the step), ms a step.

Prints one JSON object. Needs the card (the scenes render there).
"""

import argparse
import cProfile
import io
import json
import os
import pstats
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import chip_smoke  # noqa: E402
from unseenobjectswithmeanshift_torch.config import get_config  # noqa: E402
from unseenobjectswithmeanshift_torch.data.datasets import TableTopObject  # noqa: E402
from unseenobjectswithmeanshift_torch.data.loader import BatchLoader  # noqa: E402
from unseenobjectswithmeanshift_torch.train.ucn import UCNTrainer  # noqa: E402


def pass_ms(root, batch, **kw):
    """ms a sample read over one pass of the loader (fresh reader, seed 0)."""
    ds = TableTopObject(root, "train", seed=0)
    loader = BatchLoader(ds, batch, seed=0, masks=False, **kw)
    t0 = time.perf_counter()
    for b in loader:
        pass
    if kw.get("device") == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(ds)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scenes", type=int, default=8)
    p.add_argument("--batch", type=int, default=16)
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    chip_smoke.CARD = card
    chip_smoke.TOD_SCENES, chip_smoke.TOD_TEST_SCENES = args.scenes, 0
    d = tempfile.mkdtemp(prefix="uoms_loader_")
    res = {"card": card, "batch": args.batch}
    try:
        root = chip_smoke.write_tod_tree(os.path.join(d, "tod"))
        ds = TableTopObject(root, "train", seed=0)
        ds[0]                                                  # the native library's build
        ds = TableTopObject(root, "train", seed=0)
        times = []
        for i in range(len(ds)):
            t0 = time.perf_counter()
            ds[i]
            times.append((time.perf_counter() - t0) * 1e3)
        res["sample_main_thread_ms"] = statistics.mean(times)
        for tag, kw in (("sync_numpy", dict(prefetch=0)), ("thread_numpy", dict(prefetch=2)),
                        ("sync_card", dict(prefetch=0, device="cuda")),
                        ("thread_card", dict(prefetch=2, device="cuda"))):
            res[f"{tag}_ms_per_sample"] = pass_ms(root, args.batch, **kw)
        loader = BatchLoader(TableTopObject(root, "train", seed=0), args.batch, seed=0,
                             masks=False, prefetch=0, device="cuda")
        prof = cProfile.Profile()
        prof.enable()
        batches = list(loader)
        torch.cuda.synchronize()
        prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(12)
        res["profile_sync_card"] = out.getvalue().splitlines()[-20:]
        trainer = UCNTrainer(get_config("tabletop_pretrained"), 1, device="cuda")
        step = []
        for i in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(batches[0])
            torch.cuda.synchronize()
            step.append((time.perf_counter() - t0) * 1e3)
        res["step_alone_ms"] = statistics.median(step[2:])
        loader = BatchLoader(TableTopObject(root, "train", seed=0), args.batch, seed=0,
                             masks=False, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = 0
        for b in loader:
            trainer.train_step(b)
            steps += 1
        torch.cuda.synchronize()
        res["epoch_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / steps
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
