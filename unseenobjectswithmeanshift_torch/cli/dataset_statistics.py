"""Dataset statistics: per-image instance counts of any registered dataset.

The port's copy of ``unseenobjectswithmeanshift_tpu.cli.dataset_statistics``
(ref: tools/dataset_statistics.py:20-42): iterate the dataset's ground-truth
labels, count the foreground instances (table / background removed by the
reader's own label processing), and print min / max / mean and a
histogram, as used to pick max_instances / DETECTIONS_PER_IMAGE caps. The
``max:`` line is lib/datasets/get_max_num_object.py's scan (its recorded
answer for OCID is 20, test.max_instances' default), and --view's depth
panel is lib/datasets/visualize_depth_image.py's check. It reads every
dataset of ``data.datasets.get_dataset`` (``synthetic_tabletop`` included,
its root the scene count) without cv2 or PIL, and writes its --view PNGs
through ``utils/image_io.write_png``. It runs no model and no device.

Usage:
  python -m unseenobjectswithmeanshift_torch.cli.dataset_statistics \
      --dataset osd_object --root /path/to/OSD [--split test] [--limit N]

--view N also writes N sample views (RGB | depth z | label overlay) to
--view-out, the headless form of the reference's tools/view_tabletop_data.py
browsing loop (:46-59).
"""

from __future__ import annotations

import argparse
import os
from collections import Counter

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True,
                   help="registry name, e.g. osd_object / ocid_object / synthetic_tabletop")
    p.add_argument("--root", required=True)
    p.add_argument("--split", default=None,
                   help="image_set for datasets that take one (tabletop)")
    p.add_argument("--limit", type=int, default=0, help="0 = whole dataset")
    p.add_argument("--view", type=int, default=0,
                   help="write this many sample views (RGB | depth | label overlay)")
    p.add_argument("--view-out", default="./dataset_view")
    p.add_argument("--seed", type=int, default=0,
                   help="sample order for --view (random permutation)")
    args = p.parse_args(argv)

    from ..data.datasets import get_dataset

    # only TableTopObject-style datasets take an image_set; the OCID / OSD /
    # UOAIS readers enumerate their one split from disk
    kwargs = {"image_set": args.split} if args.split else {}
    dataset = get_dataset(args.dataset, args.root, **kwargs)
    n = len(dataset)
    if args.limit:
        n = min(n, args.limit)

    if args.view > 0:
        _write_views(dataset, n, args)

    counts = []
    for i in range(n):
        label = np.asarray(dataset[i]["label"])
        counts.append(int(np.count_nonzero(np.unique(label) > 0)))
        if i % 200 == 0:
            print(f"{i}/{n} ...", flush=True)

    counts = np.array(counts)
    print(f"images: {len(counts)}")
    print(f"min: {counts.min()}")
    print(f"max: {counts.max()}")
    print(f"mean: {counts.mean():.3f}")
    hist = Counter(counts.tolist())
    for k in sorted(hist):
        print(f"  {k:3d} instances: {hist[k]:5d} images ({hist[k] / len(counts):.1%})")


def _write_views(dataset, n, args):
    """Triptych PNGs: RGB | depth z | label overlay (one a sample)."""
    from ..utils.image_io import write_png
    from ..utils.visualize import label_overlay, unnormalize_image

    os.makedirs(args.view_out, exist_ok=True)
    order = np.random.RandomState(args.seed).permutation(n)[:args.view]
    for j, idx in enumerate(order):
        s = dataset[int(idx)]
        rgb = unnormalize_image(np.asarray(s["image"]))
        label = np.asarray(s["label"]).astype(np.int32)
        z = np.asarray(s["xyz"])[..., 2] if "xyz" in s else np.zeros(label.shape, np.float32)
        zmax = z.max() if z.max() > 0 else 1.0
        depth_u8 = np.clip(z / zmax * 255, 0, 255).astype(np.uint8)
        trip = np.concatenate([rgb, np.stack([depth_u8] * 3, -1), label_overlay(rgb, label)],
                              axis=1)
        path = os.path.join(args.view_out, f"sample_{int(idx):06d}.png")
        write_png(path, trip)                     # PNG channel order: RGB
        print(f"view {j + 1}/{len(order)}: {path}", flush=True)


if __name__ == "__main__":
    main()
