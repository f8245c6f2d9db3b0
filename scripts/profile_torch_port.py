"""Device-time breakdown of the PyTorch/CUDA port on one NVIDIA GPU.

    python scripts/profile_torch_port.py [--weights PATH]

1. The fused cross-attention alone at the stage-1 shape (B=1, K=480*640) and
   at the crop shape (B=8 with 2 absent, K=224*224), under torch.profiler: the
   device time of each of its passes by kernel name (pos_table_kernel,
   mask_kernel, xattn_partial_kernel, xattn_reduce_kernel, and the memset of
   the counts), with the decoder's separable positional input and, at the
   stage-1 shape, with a general posT (whose pos_table_kernel projects every
   key).
2. One full-width two-stage inference (the main path of chip_smoke.py) under
   torch.profiler: device time by kernel name, the total device time, and the
   wall time, whose difference is the device's idle share.
3. The same for one full-width UCN two-stage inference (chip_smoke.py's UCN
   path), with the defaults and with ``mean_shift.use_pallas``.
4. Eight full-width frames through each predictor (MSMFormer and UCN with
   the defaults) back to back with ``__call__`` and with ``stream`` at depth
   1 and 2: wall time, device busy time and idle share of each run.
5. With --weights (a .npz export of one MSMFormer release,
   scripts/export_release_npz.py), the MSMFormer frame of 2. on those weights
   (paired with themselves for stage 2; on the export's rendered scene if it
   holds one), dense and with decoder.tile_skip: the cross-attention's
   passes of each, side by side. --no-stream leaves out 4.

Prints one JSON line at the end with the numbers. Imports no JAX.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from unseenobjectswithmeanshift_torch.config import get_config
from unseenobjectswithmeanshift_torch.ops.fused_cross_attention import fused_uoms_cross_attention
from unseenobjectswithmeanshift_torch.pipeline.factory import build_two_stage_predictor
from unseenobjectswithmeanshift_torch.weights import load_npz_variables


def device_times(prof):
    """{kernel name: device microseconds} over the events that ran on the GPU
    (kernels, copies and fills; CPU-side operator events are left out)."""
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us()
    return out


def profile_frame(tag, fn, result):
    """One warm run of fn, then one under torch.profiler: wall time, device
    busy time, idle share and the 15 largest kernels into result[tag_*]."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per = {k: v / 1e3 for k, v in device_times(prof).items()}
    busy = sum(per.values())
    top = dict(sorted(per.items(), key=lambda kv: -kv[1])[:15])
    result.update({f"{tag}_wall_ms": wall_ms, f"{tag}_device_ms": busy,
                   f"{tag}_idle_share": max(0.0, 1 - busy / wall_ms),
                   f"{tag}_top_kernels_ms": top})
    print(f"{tag}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, idle share "
          f"{result[f'{tag}_idle_share']:.2f} (wall includes profiler overhead)", flush=True)
    for k, v in top.items():
        print(f"  {v:8.2f} ms  {k[:110]}", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description="Device-time breakdown of the port.")
    p.add_argument("--weights", help="a .npz export of one MSMFormer release")
    p.add_argument("--no-stream", action="store_true", help="leave out the stream runs")
    opts = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"device": torch.cuda.get_device_name(0)}

    for name, (B, h, w, absent, form) in {
            "stage1_B1_K307200": (1, 480, 640, (), "separable"),
            "stage1_B1_K307200_general_pos": (1, 480, 640, (), "general"),
            "crops_B8_K50176": (8, 224, 224, (3, 6), "separable")}.items():
        args, present = chip_smoke.make_inputs(B, h, w, absent, form=form)
        for _ in range(3):
            fused_uoms_cross_attention(*args, present=present)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fused_uoms_cross_attention(*args, present=present)
            torch.cuda.synchronize()
        per = {k: v / 5 / 1e3 for k, v in device_times(prof).items()}
        result[f"kernel_split_ms_{name}"] = per
        print(f"{name}: " + ", ".join(f"{k}={v:.3f} ms" for k, v in sorted(per.items(), key=lambda kv: -kv[1])), flush=True)
        del args

    image, xyz = chip_smoke.synthetic_rgbd(seed=0)
    pred = chip_smoke.decisive_predictor(seed=0)
    profile_frame("e2e", lambda: pred(image, xyz), result)
    del pred
    for tag, use_pallas in (("ucn", False), ("ucn_use_pallas", True)):
        cfg = get_config()
        cfg.mean_shift.use_pallas = use_pallas
        pred = chip_smoke.decisive_ucn_predictor(image, xyz, seed=0, cfg=cfg)
        profile_frame(tag, lambda: pred(image, xyz), result)
        del pred
    if not opts.no_stream:
        scenes = [chip_smoke.synthetic_rgbd(seed=i) for i in range(8)]
        for kind in ("msmformer", "ucn"):
            pred = (chip_smoke.decisive_predictor(seed=0) if kind == "msmformer" else
                    chip_smoke.decisive_ucn_predictor(*scenes[0], seed=0))
            profile_frame(f"{kind}_8_frames_call",
                          lambda: [pred(img, xyz) for img, xyz in scenes], result)
            for depth in (1, 2):
                profile_frame(f"{kind}_8_frames_stream_depth{depth}",
                              lambda: list(pred.stream(iter(scenes), depth=depth)), result)
            del pred
    if opts.weights:
        variables = load_npz_variables(opts.weights)
        if "scene" in variables:
            image, xyz = (torch.from_numpy(variables["scene"][k]).cuda() for k in ("image", "xyz"))
        for tag, tile_skip in (("trained_dense", False), ("trained_tile_skip", True)):
            pred = build_two_stage_predictor(variables=variables, variables_crop=variables,
                                             tile_skip=tile_skip)
            profile_frame(tag, lambda: pred(image, xyz), result)
            del pred
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
