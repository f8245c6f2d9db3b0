#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--weights PATH]

Phases, each followed by a ``phase=<name> seconds=<t>`` line:

1. build    nvcc builds every CUDA source of the port (csrc/*.cu, sm_90a).
2. check    the fused cross-attention kernel against its plain PyTorch
            version (evaluated in fp64) at the shapes of the main path:
            B=1 whole image (K = 480*640), B=8 compacted crops with 2 absent
            and B=20 crops, the most stage 2 can get (K = 224*224), with
            queries whose mask removes every key (the guard); each in both
            positional forms (the separable factors the decoder passes, and
            a general posT), on random positional inputs. Then the mask pass
            alone on random fp32 mask features and embeds (not exact in
            TF32) at B=1/K=307,200 and B=20/K=50,176 (2 absent): every mask
            bit agrees with the sign of the fp64 logit, except where the
            logit lies within MASK_MARGIN of its scale, and every count
            with its bits.
3. time     kernel (both forms, the earlier kernel's ms beside) and plain version, CUDA
            events, 3 warm-up runs then the median of 10; the bound with
            the products in 3xTF32 on the tensor cores and with all in fp32.
4. main     two-stage inference at full width (tabletop_pretrained +
            crop_tabletop_pretrained, 480x640, random weights from seed 0)
            through ``build_two_stage_predictor``; counts the kernel's
            launches per stage (and asserts that the general pos projection
            ran 0 times), checks the outputs, and checks the kernel once
            more at the crop count that stage 2 ran.
5. ucn_check  the farthest-point seeding kernel (one persistent cooperative
            launch a call) and the hill-climbing kernel (3xTF32 on wgmma)
            against their plain versions at B=1/N=307,200 (stage 1) and
            B=20/N=50,176 (the most crops stage 2 can get), on seeded
            clustered unit vectors with duplicated rows (exact ties): the
            seeds equal X[idx] bit for bit; at every step the kernel's index
            attains the fp64 maximum of the running minimum distance (from
            the kernel's own earlier seeds) within 1e-6; duplicated rows go
            to the lowest index; the first step where the chain departs from
            the fp32 plain version is printed with its gap; the climbed seeds
            agree with the plain version in fp64 within CLIMB_TOL, on the
            clustered rows and on random unit rows (where products in plain
            1xTF32 would fail it).
6. ucn_time kernel, plain and bound ms of both kernels at both shapes, the
            earlier kernels' ms beside them; FPS ms per step and its
            streaming floor (the rows of X read from device memory at every
            step over the memory rate); the climbing alone and its 3xTF32
            and fp32 bounds.
7. ucn_main UCN two-stage inference at full width (two ResNet34-8s SEGNETs,
            100 seeds, 10 steps, 20 crops of 224^2, 480x640) through
            ``build_ucn_predictor``, once with the defaults (seeding on the
            kernel, plain hill climbing) and once with
            ``mean_shift.use_pallas`` (hill climbing on the kernel too);
            counts the launches per stage, checks the outputs, times e2e with
            a breakdown, reads the peak memory, and checks both kernels again
            at the crop count that stage 2 ran.

8. tile_skip_check  the tile-skipping variant of the cross-attention kernel
            against the dense kernel (torch.equal) and against the plain
            version in fp64 (TOL), at B=1/K=307,200 and B=20/K=50,176 (2
            absent), on the check inputs (dense masks) and on concentrated
            ones (every query attends to one disc of ~10% of the pixels; at
            B=20 image 0 keeps guard queries, which pin all its tiles); prints
            the share of tiles skipped and the kernel ms of the skipping,
            dense and force_all (every tile present) variants.
9. tile_skip_main  the full-width two-stage path with decoder.tile_skip on
            both networks (same seed as main): 6 + 6 launches, pred_logits,
            pred_masks and labels equal to the dense path's (torch.equal);
            prints the skipped share per stage and layer, e2e and the
            breakdown of main. With --weights PATH (a numpy export of one
            MSMFormer release by scripts/export_release_npz.py), the same on
            those weights, paired with themselves for stage 2, with the kernel
            ms dense / skipping / force_all on each layer's own inputs.
10. masked_attention  the two masked-attention kernels
            (masked_hypersphere_attention, fused_masked_hypersphere_attention),
            driven once at B=1/K=307,200 and B=20/K=50,176 (H=8, Q=100, D=32,
            E=256, guard rows present), run a second time (torch.equal) and
            held to their plain versions in fp64 (TOL), also on ragged shapes
            (K=777, E=20, Q=128 and Q=1); kernel, plain, library ms and the
            bounds with the products in 3xTF32 and in fp32; the kernels'
            ptxas registers and spills.
11. key_stride_check  the cross-attention at the key counts of
            decoder.key_stride 2 and 3 (B=1 K=76,800 and 34,240; B=20
            K=12,544 and 5,625, whose last tile holds 57 keys and K % 4 = 1):
            against fp64 in both positional forms (TOL), the mask pass alone
            against the fp64 signs, kernel / plain / bound ms.
12. cat_check  the FPS and climbing kernels at d = 128 (the 'cat' fusion's
            embedding) with the gates of ucn_check at B=1/N=307,200 and
            B=20/N=50,176, and their ms beside the bounds.
13. presets_main  one full-width frame each of tabletop_pretrained_rgb
            (COLOR, no xyz), tabletop_pretrained with key_stride 2 and 3, ucn_depth,
            ucn_rgbd_early and ucn_rgbd_cat (use_pallas: climbing at d = 128),
            launches per stage asserted; the 'cat' kernels checked again at
            the crop count stage 2 ran.
14. grouped_towers  the 'add' and 'cat' SEGNETs as two towers and as one
            grouped stack: equal outputs, ms in turns at B=1 and 20 crops.
15. stage1_no_sync  stage 1 of the MSMFormer and UCN predictors (UCN also
            with use_pallas and with 'cat') under
            torch.cuda.set_sync_debug_mode("error").
16. stream_main  both predictors over 8 frames: stream (depth 1 and 2)
            equal to __call__ (torch.equal), frames per second of each.
17. demo_frame  the demo's per-frame function on an in-memory frame.
18. cc_check  the connected-components kernel equal to its numpy sweep on
            every clustering of the UCN frames of phases 7, 13 and 16; its ms
            beside the host sweep's.

The line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Any failure ends the run with a
traceback and a non-zero exit code. Without CUDA the script fails at once.
"""

import argparse
import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from unseenobjectswithmeanshift_torch.config import get_config
from unseenobjectswithmeanshift_torch.models import decoder as decoder_module
from unseenobjectswithmeanshift_torch.models.position_encoding import position_embedding_sine
from unseenobjectswithmeanshift_torch.ops import _build
from unseenobjectswithmeanshift_torch.ops.fused_cross_attention import (
    TILE_KEYS, fused_uoms_cross_attention, fused_uoms_cross_attention_plain, mask_pass,
    tile_occupancy, unmasked_keys,
)
from unseenobjectswithmeanshift_torch.ops.pallas_attention import (
    fused_masked_hypersphere_attention, fused_masked_hypersphere_attention_plain,
    masked_hypersphere_attention, masked_hypersphere_attention_plain,
)
from unseenobjectswithmeanshift_torch.ops import mean_shift_kernels as mean_shift_kernels_module
from unseenobjectswithmeanshift_torch.ops.mean_shift import (
    connected_components_plain, connected_components_sweep, seed_adjacency, seed_hill_climbing,
)
from unseenobjectswithmeanshift_torch.ops.mean_shift_kernels import (
    device_limits, fps_plan, fps_seeds, fps_seeds_plain, mean_shift_seeds, mean_shift_seeds_plain,
)
from unseenobjectswithmeanshift_torch.pipeline.factory import (
    build_two_stage_predictor, build_ucn_predictor,
)
from unseenobjectswithmeanshift_torch.utils.preprocess import compute_xyz
from unseenobjectswithmeanshift_torch.weights import load_npz_variables

# Kernel vs plain: the kernel (fp32 data, products in 3xTF32) is held against
# its plain version evaluated in fp64 on the same inputs. The plain version in
# fp32 is no sharper a yardstick than the kernel: it is itself 1.7e-6 to
# 3.4e-6 from fp64 at these shapes (measured on the H100), and the kernel 2e-6
# to 5e-6. The mask logits me . mf of the check inputs are exact in fp32 and
# in 3xTF32 (small integers times multiples of 1/4), so no key is masked
# differently on the two sides. 2e-5 leaves 4x over the kernel's measured
# error; an indexing or masking fault shows as O(0.1), a product in plain
# 1xTF32 as ~2e-3 (tests/test_torch_tf32_split.py). The difference from the
# fp32 plain version is printed too.
TOL = 2e-5
# The mask bits are checked apart, on fp32 inputs that TF32 does not hold
# exactly. The products in 3xTF32 put a logit within ~2^-22 of its scale
# sum_c |me_c mf_c| of the exact one (3.4e-7 in the numpy model,
# tests/test_torch_tf32_split.py); in plain 1xTF32 within ~2^-11 (1.4e-4).
# A key whose fp64 logit lies within MASK_MARGIN (16 fp32 ulps) of its scale
# may take either bit; every other key must take the fp64 logit's sign.
MASK_MARGIN = 2.0 ** -19
PEAK_FP32_FLOPS = 67e12   # H100 SXM, fp32 outside the tensor cores
# H100 SXM TF32 tensor cores (495 TFLOP/s dense); 3xTF32 spends three TF32
# products on one fp32 product
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# the earlier cross-attention kernel's ms (plain-FMA passes with a per-key pos
# projection; PERF.md section 6, H100 80GB HBM3 at 700 W), printed beside
# this run's
EARLIER_XATTN_MS = {"stage1_B1_K307200": 6.593, "crops_B8_K50176": 5.867,
                "crops_B20_K50176": 19.270}
# the earlier UCN kernels' ms (FPS one launch a step, plain-FMA climbing;
# PERF.md section 6, PR 6 run 5, H100 80GB HBM3 at 700 W), printed beside
# this run's
EARLIER_UCN_MS = {"fps_seeds": {"stage1_B1_N307200": 4.474, "crops_B20_N50176": 12.334},
                  "mean_shift_seeds": {"stage1_B1_N307200": 8.380,
                                       "crops_B20_N50176": 23.976}}
FORMS = ("separable", "general")
H, Q, D, C, CM = 8, 100, 32, 64, 256
E = H * D


def sync_print(*args):
    torch.cuda.synchronize()
    print(*args, flush=True)


def phase_done(name, t0):
    sync_print(f"phase={name} seconds={time.perf_counter() - t0:.3f}")


def make_inputs(B, h, w, absent=(), seed=0, form="separable"):
    """Seeded inputs at the decoder's full width, made on the device. Mask
    features are multiples of 1/4 and mask embeds small integers, so every
    mask logit is exact. Queries 0-3 of every image weight only channel 0,
    which is made positive everywhere, negatively: their mask removes every
    key (the guard). The positional input is random and uniform in [-1, 1],
    as the sine encoding is: posT [E, K] for form "general", the pair
    (pos_y [E/2, h], pos_x [E/2, w]) for form "separable"."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    K = h * w
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    un = lambda *s: torch.rand(*s, generator=g, device="cuda") * 2.0 - 1.0
    qn = rn(B, H, Q, D)
    qn = qn / qn.norm(dim=-1, keepdim=True)
    featT = rn(B, C, K) * 0.3
    mfT = torch.round(rn(B, CM, K) * 2.0) / 4.0
    mfT[:, 0] = mfT[:, 0].abs() + 0.25
    me = torch.round(rn(B, Q, CM) * 3.0)
    me[:, :4] = 0.0
    me[:, :4, 0] = -5.0
    pos = un(E, K) if form == "general" else (un(E // 2, h), un(E // 2, w))
    args = [qn, featT, mfT, me, pos, rn(C, E) * 0.2, rn(C, E) * 0.2, rn(E, E) * 0.1,
            rn(E) * 0.1, rn(E) * 0.1]
    present = torch.ones(B, dtype=torch.bool, device="cuda")
    for b in absent:
        present[b] = False
    return [a if isinstance(a, tuple) else a.contiguous() for a in args], present


def double(args):
    """The inputs in fp64 (either positional form)."""
    return [tuple(t.double() for t in a) if isinstance(a, tuple) else a.double() for a in args]


def work(args, present, occ=None):
    """(tensor-core operations, fp32-pipe operations, bytes) the function
    needs for these inputs: each input read once and the output written once;
    absent images need no work. The products (mask logits, k/v projections,
    q.k^, p.[v|1]) run on the tensor cores; the positional tables on the fp32
    pipe: 2 (h + w) (E/2) E operations for the separable form, 2 K E^2 for the
    general one. With occ [B, T] (tile skipping), the k/v projections and the
    attention run on the occupied tiles only, the general pos projection on
    the tiles some image occupies, and only those columns of featT and posT
    are read."""
    qn, featT, pos = args[0], args[1], args[4]
    B, K = featT.shape[0], featT.shape[2]
    n = int(present.sum())
    if occ is None:
        occ = present.bool()[:, None].expand(B, -(-K // TILE_KEYS))
    tile_keys = lambda o: min(K, int(o.sum()) * TILE_KEYS)
    k_any = tile_keys(occ.any(0))
    k_img = sum(tile_keys(occ[b]) for b in range(B))
    tc = n * 2 * Q * K * CM + k_img * (4 * C * E + 2 * H * Q * D + 2 * H * Q * (D + 1))
    nbytes = (sum(t.numel() * t.element_size() for a in args
                  for t in (a if isinstance(a, tuple) else (a,)))
              + present.numel() + qn.numel() * 4 - (B * K - k_img) * C * 4)
    if isinstance(pos, tuple):
        fma = 2 * (pos[0].shape[1] + pos[1].shape[1]) * (E // 2) * E
    else:
        fma = 2 * k_any * E * E
        nbytes -= (K - k_any) * E * 4
    return tc, fma, nbytes


def bound(flops, nbytes):
    """(bound ms, what bounds it): the larger of the operations over the fp32
    peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def tf32x3_bound(tc, fma, nbytes):
    """(bound ms, what bounds it) of a kernel with the arithmetic it uses:
    `tc` operations of products in 3xTF32 on the tensor cores, `fma` on the
    fp32 pipe (the cross-attention's pos tables, FPS, exponentials); against
    the bytes over the memory rate."""
    t_ops = tc / PEAK_3XTF32_FLOPS + fma / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def check_case(name, B, h, w, absent=(), form="separable"):
    """Kernel against its plain version in fp64 on make_inputs(B, h, w,
    absent, form=form); raises when they disagree. -> (args, present,
    max_abs_err)."""
    args, present = make_inputs(B, h, w, absent, form=form)
    got = fused_uoms_cross_attention(*args, present=present)
    want = fused_uoms_cross_attention_plain(*args, present=present)
    want64 = fused_uoms_cross_attention_plain(*double(args), present=present)
    torch.cuda.synchronize()
    err = (got.double() - want64).abs().max().item()
    err32 = (got - want).abs().max().item()
    plain_err = (want.double() - want64).abs().max().item()
    rows = (got.double() - want64).abs().amax(dim=(1, 3))      # [B, Q]
    worst_q = int(rows.amax(0).argmax())
    guard_rows = int(((args[3] @ args[2]) < 0).all(-1).sum())
    finite = bool(torch.isfinite(got).all())
    absent_zero = all(bool((got[b] == 0).all()) for b in absent)
    del got, want, want64, rows
    sync_print(f"check {name} {form}: max_abs_err={err:.3e} (vs the plain version in fp64, "
               f"tol={TOL:.0e}) vs_plain_fp32={err32:.3e} plain_fp32_vs_fp64={plain_err:.3e} "
               f"worst_query={worst_q} guard_rows={guard_rows} finite={finite} "
               f"absent_zero={absent_zero}")
    if not (err <= TOL and finite and absent_zero and guard_rows > 0):
        raise AssertionError(f"kernel disagrees with its plain version at {name} {form}")
    return args, present, err


def mask_inputs(B, K, seed=0):
    """(me [B, Q, Cm], mfT [B, Cm, K]) random in fp32, with full mantissas:
    the TF32 split of each operand leaves a nonzero low part. Queries 0-3
    are masked everywhere (their logits are at most -1.25)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    me = torch.randn(B, Q, CM, generator=g, device="cuda")
    mfT = torch.randn(B, CM, K, generator=g, device="cuda") * 0.5
    mfT[:, 0] = mfT[:, 0].abs() + 0.25
    me[:, :4] = 0.0
    me[:, :4, 0] = -5.0
    return me, mfT


def mask_mismatches(bits, cnt, me, mfT, present=None):
    """Holds the mask pass's (bits, cnt) to the fp64 logits me @ mfT of the
    present images. -> dict: "bad" keys whose bit differs from the fp64
    logit's sign although |logit| > MASK_MARGIN * scale; "near" keys within
    the margin; "flipped" keys whose bit differs at all; "worst" the largest
    |logit| / scale among the flipped keys (the measured error, 0 if none);
    "cnt_ok" every count equals the number of its bits."""
    B, Q, K = bits.shape[0], bits.shape[1], mfT.shape[-1]
    keep = (torch.ones(B, dtype=torch.bool, device=bits.device) if present is None
            else present.bool())
    out = dict(bad=0, near=0, flipped=0, worst=0.0, cnt_ok=True)
    shifts = torch.arange(32, device=bits.device, dtype=torch.int32)
    for b in keep.nonzero().flatten().tolist():   # one image at a time: fp64 [Q, K]
        got = ((bits[b].unsqueeze(-1) >> shifts) & 1).bool().reshape(Q, -1)[:, :K]
        logit = me[b].double() @ mfT[b].double()
        scale = me[b].double().abs() @ mfT[b].double().abs()
        flipped = got != (logit >= 0)
        near = logit.abs() <= MASK_MARGIN * scale
        out["bad"] += int((flipped & ~near).sum())
        out["near"] += int(near.sum())
        out["flipped"] += int(flipped.sum())
        if flipped.any():
            out["worst"] = max(out["worst"], float((logit.abs() / scale)[flipped].max()))
        out["cnt_ok"] &= bool(torch.equal(cnt[b], got.sum(-1, dtype=torch.int32)))
    return out


def check_mask_case(name, B, K, absent=()):
    """The mask pass alone on mask_inputs(B, K), held by mask_mismatches;
    raises on a bad bit or count. -> the mismatch dict."""
    me, mfT = mask_inputs(B, K)
    present = torch.ones(B, dtype=torch.bool, device="cuda")
    for b in absent:
        present[b] = False
    bits, cnt = mask_pass(me, mfT, present)
    r = mask_mismatches(bits, cnt, me, mfT, present)
    absent_zero = all(bool((bits[b] == 0).all() and (cnt[b] == 0).all()) for b in absent)
    guard = bool((cnt[present][:, :4] == 0).all())
    sync_print(f"check mask {name}: bad={r['bad']} (keys beyond the margin "
               f"{MASK_MARGIN:.2e} of the scale whose bit disagrees with the fp64 logit) "
               f"flipped={r['flipped']} near={r['near']} worst_flipped_logit/scale="
               f"{r['worst']:.3e} counts_match_bits={r['cnt_ok']} guard_rows_empty={guard} "
               f"absent_zero={absent_zero}")
    if not (r["bad"] == 0 and r["cnt_ok"] and guard and absent_zero):
        raise AssertionError(f"mask pass disagrees with the fp64 mask at {name}")
    return r


def decisive_predictor(seed=0, **kwargs):
    """build_two_stage_predictor(seed=seed, **kwargs) with random weights
    made decisive, so that stage 1 finds instances and stage 2 runs.

    Random weights give mask logits near 0: the mask head's last layer is
    scaled by 30. They also collapse every query to the same class ranking, so
    the top-k would hold background only: the class head's kernel is zeroed,
    every class scores 1/3 and the top-k takes foreground candidates, which
    the mask head then decides. low_threshold is 0.05, as in the JAX
    package's end-to-end parity test."""
    pred = build_two_stage_predictor(seed=seed, **kwargs)
    with torch.no_grad():
        for model in (pred.model, pred.model_crop):
            head = model.sem_seg_head.predictor
            head.mask_embed.layers[2].weight *= 30.0
            head.mask_embed.layers[2].bias *= 30.0
            head.class_embed.weight.zero_()
    for cfg in (pred.cfg, pred.cfg_crop):
        cfg.test.low_threshold = 0.05
    return pred


def time_ms(fn, warmup=3, reps=10):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_in_turns(fns, warmup=2, reps=5):
    """{name: median ms} of several functions timed as time_ms does, one
    run of each in turn, so that a drift of the card's clock or of its
    neighbours spreads over all of them alike."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            times[name].append(time_ms(fn, warmup=0, reps=1))
    return {name: statistics.median(t) for name, t in times.items()}


def synthetic_rgbd(seed=0, h=480, w=640):
    """A tabletop-like scene: a tilted plane with boxes and depth holes, seen by
    a 525 px pinhole camera; normalized image noise around the boxes."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ys = torch.arange(h, device="cuda", dtype=torch.float32)[:, None]
    xs = torch.arange(w, device="cuda", dtype=torch.float32)[None, :]
    depth = (0.9 + 0.4 * ys / h).expand(h, w).clone()
    image = torch.rand(h, w, 3, generator=g, device="cuda") * 0.2 - 0.1
    for i in range(6):
        y0, x0 = 80 + 50 * i, 60 + 90 * i
        box = (ys >= y0) & (ys < y0 + 90) & (xs >= x0) & (xs < x0 + 70)
        depth = torch.where(box, depth - 0.1 - 0.02 * i, depth)
        image = torch.where(box[..., None], image + 0.3 * (i % 3 - 1), image)
    holes = torch.rand(h, w, generator=g, device="cuda") < 0.05
    depth = torch.where(holes, torch.zeros_like(depth), depth)
    xyz = compute_xyz(depth, 525.0, 525.0, w / 2, h / 2)
    return image[None].contiguous(), xyz[None].contiguous()


# Mean-shift kernels. Farthest-point seeding is a chain of discrete argmaxes,
# so it cannot be held to its plain version by a tolerance on the outputs:
# the plain version's cuBLAS dot products round differently, and a near-tie
# can send the two chains apart. It is held per step instead: the kernel's
# index must attain, within FPS_TOL, the fp64 maximum of the running minimum
# distance computed from the kernel's own earlier seeds (the fp32 distances of
# unit vectors carry ~1e-7 of rounding; a wrong argmax or a stale running
# minimum shows as O(0.01)). The seeds must be X[idx] bit for bit. The hill
# climbing is held against its plain version evaluated in fp64 from the
# kernel's own seeds: with its products in 3xTF32 it measured 1.5e-7 to
# 4.0e-7 from fp64 on the H100 (B=1 to B=20; the earlier fp32 kernel 3.7e-7
# to 2.4e-6); CLIMB_TOL = 2e-5 leaves 50x, a wrong weight or a dropped key
# tile shows as O(0.01), plain 1xTF32 products as 1.2e-4 to 1.5e-4 (PERF.md).
# The fp32 plain version is itself up to 2.1e-5 from fp64 at B=20.
FPS_TOL = 1e-6
CLIMB_TOL = 2e-5
SEEDS, ITERS, KAPPA, EPSILON, EMBED = 100, 10, 20.0, 0.04, 64


def clustered_unit_vectors(B, N, seed=0, k=12, d=EMBED):
    """[B, N, d] fp32 unit rows around k directions per image, made on the
    device, with the same angular spread at every d (per-dimension noise
    0.06 sqrt(64 / d): the d = 64 rows of earlier runs, bit for bit; with
    0.06 at d = 128 the clusters are wider, seeds climb ill-conditioned
    ridges and the fp32 plain version itself lands 1.05e-4 from fp64 at
    B=20, measured on the H100; PERF.md), with exact ties: 1% of the rows copy another row, and 8 isolated
    directions each sit at 3 positions, which the farthest-point chain
    reaches once it has a seed in every cluster. -> (X, first [B] int32,
    groups [8, 3] sorted positions of the isolated rows)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    unit = lambda v: v / v.norm(dim=-1, keepdim=True)
    centers = unit(rn(B, k, d))
    assign = torch.randint(0, k, (B, N, 1), generator=g, device="cuda").expand(B, N, d)
    X = unit(torch.gather(centers, 1, assign) + 0.06 * math.sqrt(EMBED / d) * rn(B, N, d))
    src, dst = torch.randint(0, N, (2, max(1, N // 100)), generator=g, device="cuda")
    X[:, dst] = X[:, src]
    groups = torch.randperm(N, generator=g, device="cuda")[:24].view(8, 3).sort(1).values
    X[:, groups.flatten()] = unit(rn(B, 8, d)).repeat_interleave(3, dim=1)
    first = torch.randint(0, N, (B,), generator=g, device="cuda", dtype=torch.int32)
    return X.contiguous(), first, groups


def check_fps(name, X, first, groups):
    """FPS kernel per step against fp64, ties, and the departure from the
    fp32 plain version; raises on a failure. -> (seeds, indices, max gap)."""
    B, N, _ = X.shape
    seeds, idx = fps_seeds(X, first, SEEDS)
    _, pidx = fps_seeds_plain(X, first, SEEDS)
    rows = torch.arange(B, device="cuda")
    idx_l = idx.long()
    bit_exact = torch.equal(seeds, X[rows[:, None], idx_l])
    starts = torch.equal(idx[:, 0], first)
    departs = (idx != pidx).any(0).nonzero().flatten().tolist()
    dep = departs[0] if departs else None
    X64 = X.double()
    mind, gaps, dep_gap = None, [], None
    for i in range(SEEDS):
        if i > 0:
            gaps.append(mind.amax(1) - mind[rows, idx_l[:, i]])
            if i == dep:
                b = int((idx[:, i] != pidx[:, i]).nonzero()[0])
                dep_gap = (mind[b, idx_l[b, i]] - mind[b, pidx[b, i].long()]).item()
        d = 0.5 * (1.0 - torch.bmm(X64, X64[rows, idx_l[:, i]][:, :, None])[..., 0])
        mind = d if mind is None else torch.minimum(mind, d)
    max_gap = torch.stack(gaps).max().item()
    # identical rows must go to the lowest index: no later copy before it
    hit = idx_l[:, :, None, None] == groups[None, None]            # [B, S, 8, 3]
    step = torch.where(hit.any(1), hit.int().argmax(1), SEEDS)      # [B, 8, 3]
    tie_ok = bool((step[..., 1:].amin(-1) >= step[..., 0]).all())
    reached = int((step[..., 0] < SEEDS).sum())
    del X64, mind
    sync_print(f"ucn_check fps {name}: max_gap_vs_fp64={max_gap:.3e} (tol={FPS_TOL:.0e}) "
               f"seeds_bit_exact={bit_exact} first_ok={starts} tie_groups_reached={reached} "
               f"ties_to_lowest={tie_ok} departs_from_fp32_plain="
               + (f"step {dep} gap_fp64={dep_gap:.3e}" if dep is not None else "never"))
    if not (max_gap <= FPS_TOL and bit_exact and starts and tie_ok):
        raise AssertionError(f"FPS kernel disagrees with its plain version at {name}")
    return seeds, idx, max_gap


def check_climb(name, X, first, seeds, idx):
    """Hill-climbing kernel against its plain version in fp64, from the
    kernel's own FPS seeds; raises on a failure. -> max abs error."""
    Z, zidx = mean_shift_seeds(X, first, KAPPA, SEEDS, ITERS)
    Z64 = seed_hill_climbing(X.double(), seeds.double(), KAPPA, ITERS)
    Zp = seed_hill_climbing(X, seeds, KAPPA, ITERS)
    err = (Z.double() - Z64).abs().max().item()
    err32 = (Z - Zp).abs().max().item()
    plain_err = (Zp.double() - Z64).abs().max().item()
    finite = bool(torch.isfinite(Z).all())
    same_idx = torch.equal(zidx, idx)
    del Z64, Zp
    sync_print(f"ucn_check climb {name}: max_abs_err={err:.3e} (vs the plain version in fp64, "
               f"tol={CLIMB_TOL:.0e}) vs_plain_fp32={err32:.3e} "
               f"plain_fp32_vs_fp64={plain_err:.3e} finite={finite} same_fps_indices={same_idx}")
    if not (err <= CLIMB_TOL and finite and same_idx):
        raise AssertionError(f"hill-climbing kernel disagrees with its plain version at {name}")
    return err


def check_climb_random(name, B, N, seed=0, d=EMBED):
    """Hill-climbing kernel against fp64 on random unit rows, where a seed's
    own row dominates its weights: the TF32 rounding of X is not averaged
    away there, so products in plain 1xTF32 land ~1e-4 from fp64 and fail
    CLIMB_TOL whatever the clustering of the data (tests/test_torch_climb_tf32.py;
    on clustered rows the rounding can average out). Raises on a failure.
    -> max abs error."""
    g = torch.Generator(device="cuda").manual_seed(seed + 17)
    X = torch.randn(B, N, d, generator=g, device="cuda")
    X = (X / X.norm(dim=-1, keepdim=True)).contiguous()
    first = torch.randint(0, N, (B,), generator=g, device="cuda", dtype=torch.int32)
    seeds, _ = fps_seeds(X, first, SEEDS)
    Z = mean_shift_seeds(X, first, KAPPA, SEEDS, ITERS)[0]
    want = seed_hill_climbing(X.double(), seeds.double(), KAPPA, ITERS)
    err = (Z.double() - want).abs().max().item()
    sync_print(f"ucn_check climb_random {name}: max_abs_err={err:.3e} (vs the plain version in "
               f"fp64, tol={CLIMB_TOL:.0e}; plain 1xTF32 products would be ~1e-4)")
    if not (err <= CLIMB_TOL and bool(torch.isfinite(Z).all())):
        raise AssertionError(f"hill-climbing kernel disagrees with fp64 on random rows at {name}")
    return err


def check_mean_shift(name, B, N, seed=0, d=EMBED):
    X, first, groups = clustered_unit_vectors(B, N, seed, d=d)
    seeds, idx, gap = check_fps(name, X, first, groups)
    err = check_climb(name, X, first, seeds, idx)
    err_random = check_climb_random(name, B, N, seed, d=d)
    return (X, first), {"fps_max_gap": gap, "climb_max_abs_err": max(err, err_random),
                        "climb_clustered_max_abs_err": err, "climb_random_max_abs_err": err_random}


def mean_shift_work(B, N, climb: bool, d=EMBED):
    """(tensor-core operations, fp32-pipe operations, bytes) of fps_seeds, or
    of mean_shift_seeds with climb=True: X and first read once, seeds and
    indices written once. FPS takes S-1 distance passes (dot, 1 - p, x 0.5,
    min per row) on the fp32 pipe; a climbing step takes 4 S N d operations
    of products (S = Z X^T and W X, on the tensor cores in 3xTF32) and S N
    (2 + 1) more (x kappa, exp, the masking) plus S 3d for the normalization
    on the fp32 pipe."""
    fp32 = B * (SEEDS - 1) * N * (2 * d + 3)
    tc = 0
    if climb:
        tc = B * ITERS * SEEDS * N * 4 * d
        fp32 += B * ITERS * SEEDS * (N * 2 + 3 * d)
    nbytes = B * N * d * 4 + B * 4 + B * SEEDS * (d + 1) * 4
    return tc, fp32, nbytes


def decisive_ucn_predictor(image, xyz, seed=0, **kwargs):
    """build_ucn_predictor(seed=seed, **kwargs) with random weights made
    decisive: random SEGNET embeddings share a large common component, so a
    scene falls into one cluster. The fc bias of both networks is shifted by
    minus the mean raw (pre-normalization) embedding of (image, xyz), which
    spreads the unit embeddings over the sphere: for 'add' fusion on the RGB
    tower (its first half when the towers are grouped), for 'cat' on each
    tower's own half of the channels."""
    pred = build_ucn_predictor(seed=seed, **kwargs)
    nchw = lambda t: None if t is None else t.permute(0, 3, 1, 2)
    with torch.no_grad():
        for net in (pred.network, pred.network_crop):
            mean = net.raw_nchw(nchw(image), nchw(xyz)).mean(dim=(0, 2, 3))
            U, fc = net.num_units, net.fcn.resnet34_8s.fc
            if hasattr(net, "fcn_depth") and net.fusion_type == "cat":
                fc.bias -= mean[:U]
                net.fcn_depth.resnet34_8s.fc.bias -= mean[U:]
            elif net.grouped and net.fusion_type == "add":
                fc.bias[:U] -= mean
            else:
                fc.bias -= mean
    return pred


def msmformer_main_phase(results, t0):
    """4. the MSMFormer two-stage path at full width. -> kernel launches."""
    pred = decisive_predictor(seed=0)
    image, xyz = synthetic_rgbd(seed=0)
    sync_print(f"main: models built and moved, {time.perf_counter() - t0:.1f} s")

    fused_uoms_cross_attention.launches = 0
    fused_uoms_cross_attention.general_pos_launches = 0
    s1 = pred.stage1(image, xyz)
    torch.cuda.synchronize()
    n_stage1 = fused_uoms_cross_attention.launches
    refined = pred.refine(s1)
    torch.cuda.synchronize()
    launches = fused_uoms_cross_attention.launches
    general_pos = fused_uoms_cross_attention.general_pos_launches
    n_stage2 = launches - n_stage1
    n_crops = int(sum(int(c.present.sum()) for c in s1.crops))
    labels = s1.labels
    sync_print(f"main: launches stage1={n_stage1} stage2={n_stage2} "
               f"general_pos_projection={general_pos} present_crops={n_crops} "
               f"stage1_instances={int((labels.unique() >= 2).sum())} "
               f"refined_instances={int((refined.unique() >= 1).sum())}")
    assert n_stage1 == 6 and n_stage2 == 6, "the decoder did not launch the kernel once per layer"
    assert general_pos == 0, "the decoder ran the general (per-key) pos projection"
    assert n_crops >= 1, "stage 1 gave no crop, so stage 2 did not run"
    assert labels.shape == (1, 480, 640) and labels.dtype == torch.int32
    assert refined.shape == (1, 480, 640) and refined.dtype == torch.int32

    with torch.inference_mode():
        out1 = pred.model(image, xyz, light=True)
        crops = s1.crops[0]
        idx = torch.nonzero(crops.present).flatten()
        out2 = pred.model_crop(crops.rgb[idx], crops.xyz[idx], light=True)
    for tag, out in (("stage1", out1), ("stage2", out2)):
        for key in ("pred_logits", "mask_embed", "mask_features"):
            assert torch.isfinite(out[key]).all(), f"{tag} {key} is not finite"
    sync_print(f"main: outputs finite; pred_logits {tuple(out1['pred_logits'].shape)}, "
               f"crop pred_logits {tuple(out2['pred_logits'].shape)}")

    e2e, runs = median_ms(lambda: pred(image, xyz))
    sync_print(f"main: e2e_ms median of 3 = {e2e:.1f} "
               f"(runs {', '.join(f'{t:.1f}' for t in runs)}), B=1 480x640 fp32")
    with torch.inference_mode():
        parts = {
            "stage1_backbone": lambda: pred.model.pretrained_backbone(image, xyz),
            "stage1_network": lambda: pred.model(image, xyz, light=True),
            "stage1_total": lambda: pred.stage1(image, xyz),
            "refine_total": lambda: pred.refine(s1),
        }
        split = {k: median_ms(f)[0] for k, f in parts.items()}
    sync_print("main: breakdown median ms " + " ".join(f"{k}={v:.1f}" for k, v in split.items()))
    # the launch plan depends on B: hold the kernel to its plain version at
    # the crop count that stage 2 just ran
    name = f"stage2_B{n_crops}_K50176"
    del out1, out2
    torch.cuda.empty_cache()
    results[name] = {"separable": {"max_abs_err": check_case(name, n_crops, 224, 224)[2]}}
    return launches


# Tile skipping. The skipping kernel must give the dense kernel's bits, so it
# is held to it with torch.equal, and to the plain version in fp64 with TOL.


def concentrated_inputs(B, h, w, absent=(), guard_images=(), seed=0):
    """make_inputs with every query's mask concentrated on one disc of ~10% of
    the image: mask channel 1 is -4 in the disc and +4 outside, every query
    weights it by -8 and the other channels by small integers, so every key
    outside the disc is masked for every query (logits stay exact). The
    guard queries 0-3 stay only in guard_images; elsewhere they take query
    4's mask embed. -> (args, present)."""
    args, present = make_inputs(B, h, w, absent, seed)
    mfT, me = args[2], args[3]
    ys = torch.arange(h, device="cuda")[:, None]
    xs = torch.arange(w, device="cuda")[None, :]
    r = math.sqrt(0.1 * h * w / math.pi)
    disc = ((ys - 0.55 * h) ** 2 + (xs - 0.4 * w) ** 2 <= r * r).reshape(-1)
    mfT[:, 1] = torch.where(disc, -4.0, 4.0)
    guard = me[:, :4].clone()
    me.copy_(torch.round(me * 0.1))
    me[:, :, 1] = -8.0
    me[:, :4] = me[:, 4:5]
    for b in guard_images:
        me[b, :4] = guard[b]
    return args, present


def skipped_share(me, mfT, present=None):
    """Share of the (present image, 64-key tile) pairs the skipping kernel
    skips: no query of the image has an unmasked key in the tile (a query
    masked everywhere counts as unmasked everywhere: the guard).
    -> (share, occupancy [B, T])."""
    occ = tile_occupancy(unmasked_keys(me @ mfT), present)
    n = occ.shape[0] if present is None else int(present.sum())
    return 1.0 - float(occ.sum()) / (n * occ.shape[1]), occ


TILE_SKIP_CASES = {   # name: (B, h, w, absent, guard images, concentrated)
    "stage1_B1_K307200_dense_masks": (1, 480, 640, (), (), False),
    "stage1_B1_K307200_concentrated": (1, 480, 640, (), (), True),
    "crops_B20_K50176_dense_masks": (20, 224, 224, (3, 6), (), False),
    "crops_B20_K50176_concentrated": (20, 224, 224, (3, 6), (0,), True),
}


def tile_skip_check_phase():
    """8. the skipping kernel against the dense kernel and the plain version.
    -> {case: results}."""
    results = {}
    for name, (B, h, w, absent, guards, conc) in TILE_SKIP_CASES.items():
        args, present = (concentrated_inputs(B, h, w, absent, guards) if conc
                         else make_inputs(B, h, w, absent))
        call = lambda **kw: fused_uoms_cross_attention(*args, present=present, **kw)
        dense, skip = call(), call(tile_skip=True)
        force = call(tile_skip=True, tile_skip_force_all=True)
        equal = torch.equal(skip, dense) and torch.equal(force, dense)
        want64 = fused_uoms_cross_attention_plain(*double(args), present=present,
                                                  tile_skip=True)
        err = (skip.double() - want64).abs().max().item()
        finite = bool(torch.isfinite(skip).all())
        share, occ = skipped_share(args[3], args[2], present)
        del dense, skip, force, want64
        ms = time_ms(lambda: call(tile_skip=True))
        dense_ms = time_ms(call)
        force_ms = time_ms(lambda: call(tile_skip=True, tile_skip_force_all=True))
        plain_ms = time_ms(lambda: fused_uoms_cross_attention_plain(
            *args, present=present, tile_skip=True), warmup=1, reps=3)
        tc, fma, nbytes = work(args, present, occ)
        bound_ms, bound_by = tf32x3_bound(tc, fma, nbytes)
        flops = tc + fma
        results[name] = dict(max_abs_err=err, skipped_share=share, ms=ms, dense_ms=dense_ms,
                             force_all_ms=force_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, bound_fp32_ms=bound(flops, nbytes)[0])
        sync_print(f"tile_skip_check {name}: equal_to_dense={equal} max_abs_err={err:.3e} "
                   f"(vs the plain version in fp64, tol={TOL:.0e}) finite={finite} "
                   f"skipped_share={share:.4f} kernel_ms skip={ms:.3f} dense={dense_ms:.3f} "
                   f"force_all={force_ms:.3f} plain_ms={plain_ms:.3f} bound_ms={bound_ms:.3f} "
                   f"({bound_by}; {flops / 1e9:.1f} GFLOP, {nbytes / 1e9:.3f} GB)")
        if not (equal and err <= TOL and finite):
            raise AssertionError(f"the tile-skipping kernel disagrees at {name}")
        if conc and share < 0.5:
            raise AssertionError(f"concentrated masks left {share:.3f} of the tiles to skip")
        del args, present, occ
        torch.cuda.empty_cache()
    return results


@contextlib.contextmanager
def spy_cross_attention(log):
    """Appends (skipped share, guard queries, inputs) for every call the
    decoder makes to the cross-attention while active; the inputs serve to
    time the kernel on them."""
    real = decoder_module.fused_uoms_cross_attention

    def spy(*args, **kw):
        me, mfT = args[3], args[2]
        guards = int(((me @ mfT) < 0).all(-1).sum())
        log.append((skipped_share(me, mfT, kw.get("present"))[0], guards, args, kw))
        return real(*args, **kw)

    decoder_module.fused_uoms_cross_attention = spy
    try:
        yield
    finally:
        decoder_module.fused_uoms_cross_attention = real


def compare_paths(tag, dense, skip, image, xyz):
    """The tile-skipping predictor against the dense one on the same weights:
    launches 6 + 6, pred_logits, pred_masks and labels equal. -> (launches,
    per-layer skipped shares, present crops)."""
    fused_uoms_cross_attention.launches = 0
    s1 = skip.stage1(image, xyz)
    torch.cuda.synchronize()
    n1 = fused_uoms_cross_attention.launches
    refined = skip.refine(s1)
    torch.cuda.synchronize()
    launches = fused_uoms_cross_attention.launches
    d1 = dense.stage1(image, xyz)
    d_refined = dense.refine(d1)
    n_crops = int(sum(int(c.present.sum()) for c in s1.crops))
    labels_equal = torch.equal(s1.labels, d1.labels) and torch.equal(refined, d_refined)
    with torch.inference_mode():
        outs = [m(image, xyz, light=False) for m in (skip.model, dense.model)]
        idx = torch.nonzero(s1.crops[0].present).flatten()
        rgb, cxyz = s1.crops[0].rgb[idx], s1.crops[0].xyz[idx]
        outs += [m(rgb, cxyz, light=False) for m in (skip.model_crop, dense.model_crop)]
    outputs_equal = all(torch.equal(outs[i][k], outs[i + 1][k]) for i in (0, 2)
                        for k in ("pred_logits", "pred_masks"))
    finite = all(bool(torch.isfinite(o[k]).all()) for o in outs
                 for k in ("pred_logits", "pred_masks"))
    del outs
    log = []
    with torch.inference_mode(), spy_cross_attention(log):
        skip.refine(skip.stage1(image, xyz))
    shares = [entry[:2] for entry in log]
    sync_print(f"{tag}: launches stage1={n1} stage2={launches - n1} present_crops={n_crops} "
               f"stage1_instances={int((s1.labels.unique() >= 2).sum())} "
               f"labels_equal_to_dense={labels_equal} outputs_equal_to_dense={outputs_equal} "
               f"finite={finite}; skipped_share/guard queries, stage1 layers "
               + " ".join(f"{x:.4f}/{g}" for x, g in shares[:6]) + " | stage2 layers "
               + " ".join(f"{x:.4f}/{g}" for x, g in shares[6:]))
    assert n1 == 6 and launches - n1 == 6, "the decoder did not launch the kernel once per layer"
    assert labels_equal and outputs_equal and finite, f"{tag}: tile skipping changed the outputs"
    return launches, log, n_crops


def time_paths(tag, dense, skip, image, xyz, s1):
    """e2e of both paths in turns (dense, skip, skip, dense) and the skipping
    path's breakdown."""
    e2e = {}
    for name, pred in (("dense", dense), ("tile_skip", skip), ("tile_skip", skip),
                       ("dense", dense)):
        e2e.setdefault(name, []).extend(median_ms(lambda: pred(image, xyz))[1])
    with torch.inference_mode():
        parts = {
            "stage1_backbone": lambda: skip.model.pretrained_backbone(image, xyz),
            "stage1_network": lambda: skip.model(image, xyz, light=True),
            "stage1_total": lambda: skip.stage1(image, xyz),
            "refine_total": lambda: skip.refine(s1),
        }
        split = {k: median_ms(f)[0] for k, f in parts.items()}
    med = {k: statistics.median(v) for k, v in e2e.items()}
    sync_print(f"{tag}: e2e_ms median of 6 tile_skip={med['tile_skip']:.1f} "
               f"dense={med['dense']:.1f} (runs tile_skip "
               + ", ".join(f"{t:.1f}" for t in e2e["tile_skip"]) + "; dense "
               + ", ".join(f"{t:.1f}" for t in e2e["dense"])
               + "), B=1 480x640 fp32; tile_skip breakdown median ms "
               + " ".join(f"{k}={v:.1f}" for k, v in split.items()))
    return med


def tile_skip_main_phase(results, weights=None):
    """9. the two-stage path with decoder.tile_skip, against the dense path on
    the same weights. -> launches of the tile-skipping path."""
    image, xyz = synthetic_rgbd(seed=0)
    dense, skip = decisive_predictor(seed=0), decisive_predictor(seed=0, tile_skip=True)
    launches, log, n_crops = compare_paths("tile_skip_main decisive", dense, skip, image, xyz)
    assert n_crops >= 1, "stage 1 gave no crop, so stage 2 did not run"
    med = time_paths("tile_skip_main decisive", dense, skip, image, xyz, skip.stage1(image, xyz))
    results["decisive"] = dict(skipped_share=[e[0] for e in log],
                               guard_queries=[e[1] for e in log], e2e_ms=med,
                               present_crops=n_crops)
    del dense, skip, log
    torch.cuda.empty_cache()
    if weights is None:
        return launches
    variables = load_npz_variables(weights)
    if "scene" in variables:      # a held-out rendered scene stored by the export
        image, xyz = (torch.from_numpy(variables["scene"][k]).cuda() for k in ("image", "xyz"))
    preds = [build_two_stage_predictor(variables=variables, variables_crop=variables,
                                       tile_skip=ts) for ts in (False, True)]
    tag = "tile_skip_main trained"
    sync_print(f"{tag}: weights {weights} (stage 2 runs the same weights), input "
               + ("the export's rendered scene" if "scene" in variables else "synthetic_rgbd"))
    del variables
    _, log, n_crops = compare_paths(tag, *preds, image, xyz)
    med = time_paths(tag, *preds, image, xyz, preds[1].stage1(image, xyz))
    layers = []
    for i, (share, guards, args, kw) in enumerate(log):
        kw = {k: v for k, v in kw.items() if not k.startswith("tile_skip")}
        call = lambda **extra: fused_uoms_cross_attention(*args, **kw, **extra)
        t = dict(skipped_share=share, guard_queries=guards, dense_ms=time_ms(call),
                 ms=time_ms(lambda: call(tile_skip=True)),
                 force_all_ms=time_ms(lambda: call(tile_skip=True, tile_skip_force_all=True)),
                 B=args[0].shape[0])
        layers.append(t)
        sync_print(f"{tag}: stage{1 + i // 6} layer {i % 6} B={t['B']} "
                   f"skipped_share={share:.4f} guard_queries={guards} "
                   f"kernel_ms skip={t['ms']:.3f} "
                   f"dense={t['dense_ms']:.3f} force_all={t['force_all_ms']:.3f}")
    results["trained"] = dict(weights=weights, layers=layers, e2e_ms=med, present_crops=n_crops)
    return launches


def attention_inputs(B, K, seed=0, q=Q, e=E, pos=None):
    """Seeded inputs of both masked-attention kernels on the device: qn
    normalized, raw k and v, mask logits with rows 0-3 (row 0 if q < 4)
    masked everywhere (the guard), and base / pos / projections with e input
    channels (pos the sine encoding of the image unless given)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    qn = rn(B, H, q, D)
    qn = qn / qn.norm(dim=-1, keepdim=True)
    logits = rn(B, q, K)
    guard = slice(0, 4 if q > 4 else 1)
    logits[:, guard] = -1.0 - logits[:, guard].abs()
    if pos is None:
        h = 480 if K == 480 * 640 else 224
        pos = position_embedding_sine(h, K // h, E // 2).reshape(K, E).contiguous()
    proj = [rn(B, K, e) * 0.3, pos, rn(e, E) * 0.06, rn(E) * 0.1, rn(e, E) * 0.06,
            rn(E) * 0.1]
    return qn, rn(B, H, K, D), rn(B, H, K, D), logits, proj


# the earlier masked-attention kernels' ms (plain-FMA loops, four heads a
# block; PERF.md section 6, kernel table, H100 80GB HBM3 at 700 W), printed
# beside this run's
EARLIER_MATTN_MS = {
    "masked_hypersphere_attention": {"stage1_B1_K307200": 3.589, "crops_B20_K50176": 8.314},
    "fused_masked_hypersphere_attention": {"stage1_B1_K307200": 13.053,
                                           "crops_B20_K50176": 33.866}}
MATTN_DESIGN = {
    "masked_hypersphere_attention":
        "count pass writes the mask words (logits read once); one block per (head, split, "
        "image), cp.async ring of two stages of raw k, v and mask words; the split pass "
        "normalizes k and writes k^ and v^T as K-major core matrices; S and O on wgmma in "
        "3xTF32, P from the S accumulators",
    "fused_masked_hypersphere_attention":
        "the same attention as the epilogue of a k/v projection on wgmma in 3xTF32: the "
        "head's wk | wv columns split once a call and kept in shared memory (128 KB); a "
        "producer warpgroup fills a cp.async ring of three 32-channel stages of base and pos "
        "behind mbarriers for two consumer warpgroups (k, v), each stage summed from zero; "
        "k^ and v go from the accumulators to the B layouts of S and O"}
# ragged shapes of the check: (B, Q, K, E)
MATTN_RAGGED = {"ragged_Q128_K777_E20": (2, 128, 777, 20), "ragged_Q1_K777_E20": (2, 1, 777, 20)}


def ptxas_report(source, kernels):
    """{kernel: {"registers": n, "spill_bytes": stores}} from nvcc's -Xptxas=-v
    log of csrc/<source>.cu, for the entry functions whose name holds one of
    `kernels` (template variants kept apart by their mangled arguments)."""
    report, name = {}, None
    for line in _build.build_log.get(source, "").splitlines():
        if "Compiling entry function" in line:
            sym = line.split("'")[1]
            k = next((k for k in kernels if k in sym), None)
            args = re.match(r"I((?:Lb[01]E)+)E", sym[sym.index(k) + len(k):]) if k else None
            name = k and k + (f"<{','.join(re.findall(r'Lb([01])E', args.group(1)))}>"
                              if args else "")
        elif name and "spill stores" in line:
            report[name] = {"spill_bytes": int(line.split("bytes spill stores")[0].split(",")[-1])}
        elif name and "Used" in line and "registers" in line:
            report[name]["registers"] = int(line.split("Used ")[1].split(" registers")[0])
    return report


def masked_attention_phase():
    """10. both masked-attention kernels: driven once per shape (counted),
    held to their plain versions in fp64 at the driven shapes and on ragged
    ones, run twice for determinism, timed. -> ({kernel: launches},
    {kernel: {shape: results}}, ptxas report)."""
    cases = {"stage1_B1_K307200": (1, 480 * 640), "crops_B20_K50176": (20, 224 * 224)}
    kernels = (masked_hypersphere_attention, fused_masked_hypersphere_attention)
    launches = {fn.__name__: 0 for fn in kernels}
    results = {fn.__name__: {} for fn in kernels}
    regs = ptxas_report("masked_attention", ("mha_partial_kernel", "fused_partial_kernel"))
    for kname, r in regs.items():
        sync_print(f"masked_attention ptxas {kname}: registers={r.get('registers')} "
                   f"spill_bytes={r['spill_bytes']}")
    d = lambda t: t.double()
    for name, (B, K) in cases.items():
        qn, k, v, logits, proj = attention_inputs(B, K)
        row5 = lambda: masked_hypersphere_attention(qn, k, v, logits, k_normalized=False)
        row6 = lambda: fused_masked_hypersphere_attention(qn, *proj, logits)
        for fn in kernels:
            fn.launches = 0
        got5, got6 = row5(), row6()
        torch.cuda.synchronize()
        for fn in kernels:     # the driving calls; the checks and timing below do not count
            launches[fn.__name__] += fn.launches
        same5, same6 = torch.equal(got5, row5()), torch.equal(got6, row6())
        want5 = masked_hypersphere_attention_plain(d(qn), d(k), d(v), d(logits))
        want6 = fused_masked_hypersphere_attention_plain(d(qn), *map(d, proj), d(logits))
        guard_rows = int((logits < 0).all(-1).sum())
        # the library yardstick of row 5: one SDPA call on normalized k with the
        # guard-corrected bias, both built outside the timed call
        kn = k / torch.sqrt((k * k).sum(-1, keepdim=True) + 1e-24)
        masked = logits < 0
        bias = torch.zeros_like(logits).masked_fill(masked & ~masked.all(-1, keepdim=True),
                                                    float("-inf"))[:, None]
        sdpa = lambda: F.scaled_dot_product_attention(qn, kn, v, attn_mask=bias, scale=30.0)
        lib_err = (sdpa().double() - want5).abs().max().item()
        for kernel, got, want, same, fn, plain, flops, nbytes in (
                ("masked_hypersphere_attention", got5, want5, same5, row5,
                 lambda: masked_hypersphere_attention_plain(qn, k, v, logits),
                 B * (2 * H * Q * K * D + 2 * H * Q * K * (D + 1)),
                 4 * (qn.numel() * 2 + k.numel() + v.numel() + logits.numel())),
                ("fused_masked_hypersphere_attention", got6, want6, same6, row6,
                 lambda: fused_masked_hypersphere_attention_plain(qn, *proj, logits),
                 B * (2 * H * Q * K * D + 2 * H * Q * K * (D + 1) + 2 * 2 * K * E * E),
                 4 * (qn.numel() * 2 + logits.numel() + sum(t.numel() for t in proj)))):
            err = (got.double() - want).abs().max().item()
            finite = bool(torch.isfinite(got).all())
            ms = time_ms(fn)
            plain_ms = time_ms(plain, warmup=1, reps=3)
            library_ms = time_ms(sdpa) if kernel == "masked_hypersphere_attention" else None
            bound_ms, bound_by = tf32x3_bound(flops, 0, nbytes)
            bound_fp32_ms = bound(flops, nbytes)[0]
            results[kernel][name] = dict(max_abs_err=err, deterministic=same, ms=ms,
                                         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                         bound_fp32_ms=bound_fp32_ms, library_ms=library_ms,
                                         gflop=flops / 1e9, gbytes=nbytes / 1e9)
            sync_print(f"masked_attention {kernel} {name}: max_abs_err={err:.3e} (vs the plain "
                       f"version in fp64, tol={TOL:.0e}) finite={finite} guard_rows={guard_rows} "
                       f"two_runs_equal={same} kernel_ms={ms:.3f} (earlier kernel: "
                       f"{EARLIER_MATTN_MS[kernel][name]:.3f}) plain_ms={plain_ms:.3f} "
                       f"bound_ms={bound_ms:.3f} ({bound_by}; 3xTF32 products "
                       f"{flops / 1e9:.1f} GFLOP at {PEAK_3XTF32_FLOPS / 1e12:.0f} TFLOP/s, "
                       f"{nbytes / 1e9:.3f} GB) bound_fp32_ms={bound_fp32_ms:.3f} "
                       f"achieved={flops / ms / 1e9:.2f} TFLOP/s {nbytes / ms / 1e9:.3f} TB/s"
                       + (f" library_ms={library_ms:.3f} (F.scaled_dot_product_attention on "
                          f"k normalized and the guard-corrected bias, both built outside the "
                          f"timed call; {lib_err:.2e} from fp64; kernel/library "
                          f"{ms / library_ms:.3f})" if library_ms is not None
                          else " library_ms=null (no one PyTorch call computes it)"))
            if not (err <= TOL and finite and guard_rows > 0 and same):
                raise AssertionError(f"{kernel} disagrees with its plain version at {name}, "
                                     f"or two runs differ")
        del qn, k, v, logits, proj, got5, got6, want5, want6, kn, bias
        torch.cuda.empty_cache()
    for kernel, n in launches.items():
        if n != len(cases):
            raise AssertionError(f"{kernel} launched {n} times while driven {len(cases)} times")
    for name, (B, q, K, e) in MATTN_RAGGED.items():
        g = torch.Generator(device="cuda").manual_seed(1)
        qn, k, v, logits, proj = attention_inputs(
            B, K, seed=1, q=q, e=e,
            pos=torch.rand(K, e, generator=g, device="cuda") * 2.0 - 1.0)
        for kernel, got, want in (
                ("masked_hypersphere_attention",
                 masked_hypersphere_attention(qn, k, v, logits),
                 masked_hypersphere_attention_plain(d(qn), d(k), d(v), d(logits))),
                ("fused_masked_hypersphere_attention",
                 fused_masked_hypersphere_attention(qn, *proj, logits),
                 fused_masked_hypersphere_attention_plain(d(qn), *map(d, proj), d(logits)))):
            err = (got.double() - want).abs().max().item()
            results[kernel][name] = dict(max_abs_err=err)
            sync_print(f"masked_attention {kernel} {name} (B={B} Q={q} K={K} E={e}): "
                       f"max_abs_err={err:.3e} (tol={TOL:.0e})")
            if not (err <= TOL and bool(torch.isfinite(got).all())):
                raise AssertionError(f"{kernel} disagrees with its plain version at {name}")
    return launches, results, regs


def median_ms(fn, reps=3):
    """Host-clock median of `reps` synchronized runs after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - ts) * 1e3)
    return statistics.median(times), times


UCN_SHAPES = {"stage1_B1_N307200": (1, 480 * 640), "crops_B20_N50176": (20, 224 * 224)}


def ucn_check_phase():
    """5. both mean-shift kernels against their plain versions."""
    cases, results = {}, {}
    for name, (B, N) in UCN_SHAPES.items():
        cases[name], results[name] = check_mean_shift(name, B, N)
        torch.cuda.empty_cache()
    return cases, results


def ucn_time_phase(cases, results):
    """6. kernel, plain and bound ms of both kernels at both shapes, beside
    the earlier kernels' ms. FPS: also the design's streaming floor, the rows
    of X a step still reads from device memory (fps_plan: not in shared
    memory, registers or the L2) over the memory rate for S-1 steps.
    Climbing: the 3xTF32 bound beside the fp32 one, and the climbing alone
    (mean_shift_seeds minus fps_seeds, timed in turns)."""
    for name, (X, first) in cases.items():
        B, N, _ = X.shape
        r = results[name]
        kernel_ms = time_in_turns({
            "fps_seeds": lambda: fps_seeds(X, first, SEEDS),
            "mean_shift_seeds": lambda: mean_shift_seeds(X, first, KAPPA, SEEDS, ITERS)})
        for kernel, plain, climb in (
                ("fps_seeds", lambda: fps_seeds_plain(X, first, SEEDS), False),
                ("mean_shift_seeds",
                 lambda: mean_shift_seeds_plain(X, first, KAPPA, SEEDS, ITERS), True)):
            ms = kernel_ms[kernel]
            plain_ms = time_ms(plain, warmup=1, reps=3)
            tc, fp32, nbytes = mean_shift_work(B, N, climb)
            bound_ms, bound_by = tf32x3_bound(tc, fp32, nbytes)
            bound_fp32_ms = bound(tc + fp32, nbytes)[0]
            r[kernel] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                             bound_fp32_ms=bound_fp32_ms)
            earlier = EARLIER_UCN_MS[kernel].get(name)
            head = (f"ucn_time {kernel} {name}: kernel_ms={ms:.3f} "
                    + (f"(earlier kernel: {earlier:.3f}) " if earlier else "")
                    + f"plain_ms={plain_ms:.3f} ")
            if not climb:
                plan = fps_plan(B, N, **device_limits(X.device))
                dram_mb, l2_mb = (plan[k] * EMBED * 4 / 1e6 for k in ("streamed_rows",
                                                                      "l2_held_rows"))
                floor_ms = dram_mb * 1e6 * (SEEDS - 1) / PEAK_BYTES * 1e3
                r[kernel].update(ms_per_step=ms / (SEEDS - 1), streaming_floor_ms=floor_ms,
                                 streamed_mb_per_step=dram_mb, l2_held_mb=l2_mb)
                sync_print(head + f"ms_per_step={ms / (SEEDS - 1) * 1e3:.2f}us "
                           f"bound_ms={bound_ms:.4f} ({bound_by}; {fp32 / 1e9:.2f} GFLOP fp32, "
                           f"{nbytes / 1e9:.4f} GB) streaming_floor_ms={floor_ms:.3f} "
                           f"({dram_mb:.1f} MB a step read from device memory, {l2_mb:.1f} MB "
                           f"kept in the L2; {plan['grid']} blocks, {plan['resident_rows']} "
                           f"rows in shared memory, {plan['register_rows'] * 32} in registers "
                           f"and {plan['l2_rows']} in the L2 of {plan['rows_per_block']} a "
                           "block)")
            else:
                climb_ms = ms - r["fps_seeds"]["ms"]
                r[kernel].update(climb_ms=climb_ms, climb_ms_per_step=climb_ms / ITERS)
                sync_print(head + f"climbing_alone_ms={climb_ms:.3f} "
                           f"(per step {climb_ms / ITERS:.3f}) bound_ms={bound_ms:.4f} "
                           f"({bound_by}; 3xTF32 products {tc / 1e9:.1f} GFLOP at "
                           f"{PEAK_3XTF32_FLOPS / 1e12:.0f} TFLOP/s, {fp32 / 1e9:.2f} GFLOP "
                           f"fp32) bound_fp32_ms={bound_fp32_ms:.4f}")
        # connected components of the climbed seeds: the kernel (CUDA events)
        # and the numpy sweep it replaced (host clock, one copy to the host)
        within = seed_adjacency(mean_shift_seeds(X, first, KAPPA, SEEDS, ITERS)[0], EPSILON)
        cc_ms = time_ms(lambda: connected_components_sweep(within))
        host_ms = median_ms(lambda: connected_components_plain(within), reps=5)[0]
        results[name]["connected_components_ms"] = cc_ms
        results[name]["connected_components_host_ms"] = host_ms
        sync_print(f"ucn_time connected_components {name}: kernel_ms={cc_ms:.4f} "
                   f"host_sweep_ms={host_ms:.3f} (components "
                   f"{int(connected_components_sweep(within).max()) + 1} at most per image)")


def ucn_main_phase(results):
    """7. the UCN two-stage path at full width, defaults and use_pallas.
    -> {path: {kernel name: launches}}."""
    image, xyz = synthetic_rgbd(seed=0)
    with torch.inference_mode():
        raw = build_ucn_predictor(seed=0).stage1(image, xyz)
    sync_print(f"ucn_main: plain random weights (seed 0): stage-1 clusters "
               f"{int(raw.n_clusters[0])}, present crops "
               f"{int(sum(int(c.present.sum()) for c in raw.crops))}")
    del raw
    launches, crop_counts = {}, set()
    for path, use_pallas in (("defaults", False), ("use_pallas", True)):
        cfg = get_config()
        cfg.mean_shift.use_pallas = use_pallas
        pred = decisive_ucn_predictor(image, xyz, seed=0, cfg=cfg)
        zero_counts()
        s1 = pred.stage1(image, xyz)
        torch.cuda.synchronize()
        n1 = (fps_seeds.launches, mean_shift_seeds.launches,
              connected_components_sweep.launches)
        refined = pred.refine(s1)
        torch.cuda.synchronize()
        n2 = (fps_seeds.launches - n1[0], mean_shift_seeds.launches - n1[1],
              connected_components_sweep.launches - n1[2])
        launches[path] = {"fps_seeds": fps_seeds.launches,
                          "mean_shift_seeds": mean_shift_seeds.launches,
                          "connected_components": connected_components_sweep.launches}
        n_crops = int(sum(int(c.present.sum()) for c in s1.crops))
        crop_counts.add(n_crops)
        labels = s1.labels
        sync_print(f"ucn_main {path}: launches fps_seeds stage1={n1[0]} stage2={n2[0]}, "
                   f"mean_shift_seeds stage1={n1[1]} stage2={n2[1]}, connected_components "
                   f"stage1={n1[2]} stage2={n2[2]}; present_crops={n_crops} "
                   f"stage1_clusters={int(s1.n_clusters[0])} "
                   f"refined_instances={int((refined.unique() >= 1).sum())}")
        assert fused_uoms_cross_attention.launches == 0
        assert n_crops >= 1, "stage 1 gave no crop, so stage 2 did not run"
        assert n1[0] == 1 and n2[0] == 1, "the seeding kernel did not run once per stage"
        assert n1[1] == n2[1] == (1 if use_pallas else 0), "climbing kernel launches"
        assert n1[2] == n2[2] == 1, "the connected-components kernel did not run once per stage"
        assert labels.shape == (1, 480, 640) and labels.dtype == torch.int32
        assert refined.shape == (1, 480, 640) and refined.dtype == torch.int32
        with torch.inference_mode():
            feats = pred.network(image, xyz)
            crops = s1.crops[0]                       # B = 1
            idx = torch.nonzero(crops.present).flatten()
            rgb, dep = crops.rgb[idx], crops.xyz[idx]
            feats_crop = pred.network_crop(rgb, dep)
        assert torch.isfinite(feats).all() and torch.isfinite(feats_crop).all()
        sync_print(f"ucn_main {path}: features finite; {tuple(feats.shape)}, "
                   f"crops {tuple(feats_crop.shape)}")

        e2e, runs = median_ms(lambda: pred(image, xyz))
        with torch.inference_mode():
            parts = {"backbone": lambda: pred.network(image, xyz),
                     "clustering": lambda: pred.cluster(feats),
                     "stage1_total": lambda: pred.stage1(image, xyz),
                     "crop_backbone": lambda: pred.network_crop(rgb, dep),
                     "crop_clustering": lambda: pred.cluster(feats_crop),
                     "refine_total": lambda: pred.refine(s1)}
            split = {k: median_ms(f)[0] for k, f in parts.items()}
        del feats, feats_crop, rgb, dep
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        pred(image, xyz)
        peak = torch.cuda.max_memory_allocated() / 2**30
        sync_print(f"ucn_main {path}: e2e_ms median of 3 = {e2e:.1f} "
                   f"(runs {', '.join(f'{t:.1f}' for t in runs)}), B=1 480x640 fp32; "
                   "breakdown median ms " + " ".join(f"{k}={v:.1f}" for k, v in split.items())
                   + f"; peak_allocated_GiB={peak:.3f} (allocated before the frame "
                   f"{before:.3f}: weights, inputs, stage-1 result)")
        del pred, s1, refined
        torch.cuda.empty_cache()
    # the launch plans depend on B: hold both kernels to their plain versions
    # at the crop counts that stage 2 just ran
    for n in sorted(crop_counts):
        name = f"stage2_B{n}_N50176"
        results[name] = check_mean_shift(name, n, 224 * 224, seed=1)[1]
        torch.cuda.empty_cache()
    return launches


# Row 1 at the key counts of decoder.key_stride (whole image and crops at
# strides 2 and 3): the first K on the card that are not multiples of the
# 64-key tile or of 4. K = 5,625 = 87 * 64 + 57 leaves 57 keys in the last
# tile and K % 4 = 1 (the kernel's scalar copies of the ragged rows).
KEY_STRIDE_SHAPES = {"stride2_stage1_B1_K76800": (1, 240, 320),
                     "stride2_crops_B20_K12544": (20, 112, 112),
                     "stride3_stage1_B1_K34240": (1, 160, 214),
                     "stride3_crops_B20_K5625": (20, 75, 75)}


def key_stride_check_phase():
    """Row 1 at KEY_STRIDE_SHAPES: kernel against its plain version in fp64
    (TOL) in both positional forms, the mask pass alone against the fp64
    signs, then kernel, plain and bound ms. -> {case: results}."""
    results = {}
    for name, (B, h, w) in KEY_STRIDE_SHAPES.items():
        K = h * w
        r = results[name] = {"K": K, "last_tile_keys": K % TILE_KEYS or TILE_KEYS,
                             "K_mod_4": K % 4}
        r["max_abs_err"] = max(check_case(name, B, h, w, form=form)[2] for form in FORMS)
        r["mask"] = check_mask_case(name, B, K)
        torch.cuda.empty_cache()
        args, present = make_inputs(B, h, w)
        r["ms"] = time_ms(lambda: fused_uoms_cross_attention(*args, present=present))
        r["plain_ms"] = time_ms(lambda: fused_uoms_cross_attention_plain(*args, present=present),
                                warmup=1, reps=3)
        tc, fma, nbytes = work(args, present)
        r["bound_ms"], r["bound_by"] = tf32x3_bound(tc, fma, nbytes)
        sync_print(f"key_stride_check {name}: K={K} last_tile_keys={r['last_tile_keys']} "
                   f"K%4={K % 4} max_abs_err={r['max_abs_err']:.3e} kernel_ms={r['ms']:.3f} "
                   f"plain_ms={r['plain_ms']:.3f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']})")
        del args, present
        torch.cuda.empty_cache()
    return results


def time_mean_shift(name, X, first, d, r):
    """Kernel, plain and bound ms of both mean-shift kernels on (X, first),
    into r[kernel]; the climbing alone is mean_shift_seeds minus fps_seeds
    (timed in turns)."""
    B, N, _ = X.shape
    kernel_ms = time_in_turns({
        "fps_seeds": lambda: fps_seeds(X, first, SEEDS),
        "mean_shift_seeds": lambda: mean_shift_seeds(X, first, KAPPA, SEEDS, ITERS)})
    for kernel, plain, climb in (
            ("fps_seeds", lambda: fps_seeds_plain(X, first, SEEDS), False),
            ("mean_shift_seeds",
             lambda: mean_shift_seeds_plain(X, first, KAPPA, SEEDS, ITERS), True)):
        tc, fp32, nbytes = mean_shift_work(B, N, climb, d=d)
        bound_ms, bound_by = tf32x3_bound(tc, fp32, nbytes)
        r[kernel] = dict(ms=kernel_ms[kernel], plain_ms=time_ms(plain, warmup=1, reps=3),
                         bound_ms=bound_ms, bound_by=bound_by)
    r["mean_shift_seeds"]["climb_ms"] = (r["mean_shift_seeds"]["ms"] - r["fps_seeds"]["ms"])
    sync_print(f"time d={d} {name}: " + " ".join(
        f"{k} kernel_ms={v['ms']:.3f} plain_ms={v['plain_ms']:.3f} bound_ms={v['bound_ms']:.4f} "
        f"({v['bound_by']})" for k, v in r.items() if isinstance(v, dict))
        + f" climbing_alone_ms={r['mean_shift_seeds']['climb_ms']:.3f}")


def cat_check_phase():
    """Rows 3-4 at d = 128 (the 'cat' embedding): the gates of ucn_check
    (FPS per step within FPS_TOL of fp64, seeds bit-exact, ties to the
    lowest index; the climbing within CLIMB_TOL of fp64 on clustered and on
    random rows) at B=1/N=307,200 and B=20/N=50,176, then their times.
    -> {case: results}."""
    results = {}
    for name, (B, N) in UCN_SHAPES.items():
        (X, first), results[name] = check_mean_shift(f"d128_{name}", B, N, d=128)
        time_mean_shift(f"d128_{name}", X, first, 128, results[name])
        del X, first
        torch.cuda.empty_cache()
    return results


class ConnectedComponentsSpy:
    """Records every seed adjacency the UCN clustering sweeps, and the
    labels it got, inside the `with` block (the main paths' clusterings),
    for cc_check: it wraps the clustering's call of
    ops.mean_shift.connected_components, and recomputes the adjacency the
    call builds (the same op on the same seeds). Launches stay counted in
    connected_components_sweep.launches."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self.orig = mean_shift_kernels_module.connected_components

        def spy(Z, epsilon):
            labels = self.orig(Z, epsilon)
            self.calls.append((seed_adjacency(Z, epsilon), labels.clone()))
            return labels

        mean_shift_kernels_module.connected_components = spy
        return self

    def __exit__(self, *exc):
        mean_shift_kernels_module.connected_components = self.orig


def cc_check_phase(spy):
    """The connected-components kernel against its plain numpy sweep on every
    adjacency of the run's UCN clusterings (torch.equal), then kernel and
    host-sweep ms at B=1 and B=20. -> results."""
    images = sum(w.shape[0] for w, _ in spy.calls)
    equal = all(torch.equal(lab.cpu(), connected_components_plain(w).cpu())
                for w, lab in spy.calls)
    comps = max(int(lab.max()) + 1 for _, lab in spy.calls) if spy.calls else 0
    sync_print(f"cc_check: {len(spy.calls)} clusterings, {images} images, kernel equal to the "
               f"numpy sweep={equal}, most components in an image={comps}")
    if not spy.calls or not equal:
        raise AssertionError("connected-components kernel disagrees with the numpy sweep "
                             "(or the run made no UCN clustering)")
    r = {"clusterings": len(spy.calls), "images": images, "equal": equal}
    for B in (1, 20):
        within = torch.cat([w for w, _ in spy.calls])[:1].expand(B, -1, -1).contiguous()
        r[f"B{B}"] = {"ms": time_ms(lambda: connected_components_sweep(within)),
                      "plain_ms": median_ms(lambda: connected_components_plain(within),
                                            reps=5)[0]}
    sync_print("cc_check: " + " ".join(f"{k} kernel_ms={v['ms']:.4f} host_sweep_ms="
                                       f"{v['plain_ms']:.3f}" for k, v in r.items()
                                       if isinstance(v, dict)))
    return r


def kernel_counts():
    """The launch counts of every kernel wrapper on the serving paths."""
    return {"fused_uoms_cross_attention": fused_uoms_cross_attention.launches,
            "fps_seeds": fps_seeds.launches, "mean_shift_seeds": mean_shift_seeds.launches,
            "connected_components": connected_components_sweep.launches}


def zero_counts():
    fused_uoms_cross_attention.launches = fused_uoms_cross_attention.general_pos_launches = 0
    fps_seeds.launches = mean_shift_seeds.launches = connected_components_sweep.launches = 0


# presets_main: one full-width frame of each configuration that the flagship
# paths do not run, with the kernel launches each stage must make.
PRESET_FRAMES = {   # tag: (pipeline, preset, factory kwargs, use_pallas)
    "tabletop_pretrained_rgb": ("msmformer", "tabletop_pretrained_rgb", {"no_depth": True}, False),
    "key_stride_2": ("msmformer", "tabletop_pretrained", {"key_stride": 2}, False),
    "key_stride_3": ("msmformer", "tabletop_pretrained", {"key_stride": 3}, False),
    "ucn_depth": ("ucn", "ucn_depth", {}, False),
    "ucn_rgbd_early": ("ucn", "ucn_rgbd_early", {}, False),
    "ucn_rgbd_cat": ("ucn", "ucn_rgbd_cat", {}, True),
}


def preset_predictor(kind, preset, kwargs, use_pallas, image, xyz, seed=0):
    if kind == "msmformer":
        return decisive_predictor(seed=seed, preset=preset, **kwargs)
    cfg = get_config(preset)
    cfg.mean_shift.use_pallas = use_pallas
    return decisive_ucn_predictor(image, xyz, seed=seed, preset=preset, cfg=cfg,
                                  cfg_crop=cfg, **kwargs)


def presets_main_phase(results):
    """One full-width frame of each PRESET_FRAMES entry through the
    factories: kernel launches per stage asserted (MSMFormer 6 + 6
    cross-attention; UCN 1 + 1 FPS and 1 + 1 connected components, and 1 + 1
    climbing with use_pallas; nothing else), int32 [1, 480, 640] labels, >= 1
    crop, e2e ms. The 'cat' frame's FPS and climbing (d = 128) are checked
    and timed again at the crop count stage 2 ran. -> {tag: launches}."""
    image, xyz = synthetic_rgbd(seed=0)
    launches = {}
    for tag, (kind, preset, kwargs, use_pallas) in PRESET_FRAMES.items():
        color = kwargs.get("no_depth", False)
        frame_xyz = None if color else xyz
        pred = preset_predictor(kind, preset, kwargs, use_pallas, image, frame_xyz)
        zero_counts()
        s1 = pred.stage1(image, frame_xyz)
        torch.cuda.synchronize()
        n1 = kernel_counts()
        refined = pred.refine(s1)
        torch.cuda.synchronize()
        n2 = {k: v - n1[k] for k, v in kernel_counts().items()}
        launches[tag] = {k: n1[k] + n2[k] for k in n1}
        n_crops = int(sum(int(c.present.sum()) for c in s1.crops))
        e2e = median_ms(lambda: pred(image, frame_xyz))[0]
        sync_print(f"presets_main {tag}: launches stage1={n1} stage2={n2} present_crops="
                   f"{n_crops} e2e_ms={e2e:.1f}"
                   + (f" embedding={pred.network.out_channels}" if kind == "ucn" else ""))
        if kind == "msmformer":
            want1 = want2 = {"fused_uoms_cross_attention": 6, "fps_seeds": 0,
                             "mean_shift_seeds": 0, "connected_components": 0}
        else:
            want1 = want2 = {"fused_uoms_cross_attention": 0, "fps_seeds": 1,
                             "mean_shift_seeds": int(use_pallas), "connected_components": 1}
        assert n1 == want1 and n2 == want2, f"{tag}: launches {n1} + {n2}, expected {want1}"
        assert n_crops >= 1, f"{tag}: stage 1 gave no crop, so stage 2 did not run"
        assert s1.labels.shape == refined.shape == (1, 480, 640)
        assert s1.labels.dtype == refined.dtype == torch.int32
        results[tag] = {"e2e_ms": e2e, "present_crops": n_crops, "launches_stage1": n1,
                        "launches_stage2": n2}
        if tag == "ucn_rgbd_cat":
            name = f"d128_stage2_B{n_crops}_N50176"
            (X, first), results[name] = check_mean_shift(name, n_crops, 224 * 224, seed=1,
                                                         d=128)
            time_mean_shift(name, X, first, 128, results[name])
            del X, first
        del pred, s1, refined
        torch.cuda.empty_cache()
    return launches


def grouped_towers_phase(results):
    """The SEGNET of 'add' and 'cat' fusion as two towers and as one grouped
    stack (grouped_towers, a TPU device to fill the MXU), at B=1 480x640 and
    on 20 crops of 224^2: ms in turns, and the grouped output against the
    two towers' (the same weights, fused)."""
    from unseenobjectswithmeanshift_torch.models.segnet import SEGNET
    from unseenobjectswithmeanshift_torch.weights import fuse_tower_state, init_random

    image, xyz = synthetic_rgbd(seed=0)
    g = torch.Generator(device="cuda").manual_seed(3)
    crops = (torch.rand(20, 224, 224, 3, generator=g, device="cuda") - 0.5,
             torch.rand(20, 224, 224, 3, generator=g, device="cuda"))
    for fusion in ("add", "cat"):
        two = init_random(SEGNET(64, "RGBD", fusion), torch.Generator().manual_seed(0))
        grouped = SEGNET(64, "RGBD", fusion, grouped_towers=True)
        grouped.load_state_dict(fuse_tower_state(two.state_dict()))
        two, grouped = two.cuda().eval(), grouped.cuda().eval()
        for shape, (img, dep) in (("B1_480x640", (image, xyz)), ("B20_224x224", crops)):
            with torch.inference_mode():
                err = (two(img, dep) - grouped(img, dep)).abs().max().item()
                ms = time_in_turns({"two_towers": lambda: two(img, dep),
                                    "grouped": lambda: grouped(img, dep)})
            results[f"{fusion}_{shape}"] = {**ms, "max_abs_diff": err}
            sync_print(f"grouped_towers {fusion} {shape}: two_towers_ms={ms['two_towers']:.3f} "
                       f"grouped_ms={ms['grouped']:.3f} max_abs_diff={err:.3e}")
            assert err <= 1e-4, "the grouped stack disagrees with the two towers"
        del two, grouped
        torch.cuda.empty_cache()


def stage1_no_sync_phase():
    """Stage 1 of the MSMFormer and UCN predictors (the defaults, and UCN with
    use_pallas and with 'cat' fusion) under
    torch.cuda.set_sync_debug_mode("error"): any host sync raises."""
    image, xyz = synthetic_rgbd(seed=0)
    preds = {"msmformer": decisive_predictor(seed=0),
             "ucn": decisive_ucn_predictor(image, xyz, seed=0)}
    for tag, preset, use_pallas in (("ucn_use_pallas", "tabletop_pretrained", True),
                                    ("ucn_rgbd_cat", "ucn_rgbd_cat", True)):
        preds[tag] = preset_predictor("ucn", preset, {}, use_pallas, image, xyz)
    for pred in preds.values():          # warm-up: libraries loaded, plans cached
        pred.stage1(image, xyz)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for pred in preds.values():
            pred.stage1(image, xyz)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    sync_print(f"stage1_no_sync: stage 1 of {', '.join(preds)} queued under "
               "set_sync_debug_mode('error') with no host sync")
    return list(preds)


def stream_main_phase(results, frames=8):
    """Both predictors over `frames` full-width frames: stream with depth 1
    and 2 gives __call__'s outputs (torch.equal), then frames per second of
    back-to-back __call__ and of stream at both depths, timed in turns (host
    clock around the whole run, ending in a synchronize; median of 3)."""
    scenes = [synthetic_rgbd(seed=i) for i in range(frames)]
    preds = {"msmformer": decisive_predictor(seed=0),
             "ucn": decisive_ucn_predictor(*scenes[0], seed=0)}
    for tag, pred in preds.items():
        want = [pred(img, xyz) for img, xyz in scenes]
        crops = sum(int(not torch.equal(l, r)) for l, r in want)
        for depth in (1, 2):
            got = list(pred.stream(iter(scenes), depth=depth))
            equal = len(got) == frames and all(
                torch.equal(gl, wl) and torch.equal(gr, wr)
                for (gl, gr), (wl, wr) in zip(got, want))
            if not equal:
                raise AssertionError(f"{tag} stream(depth={depth}) differs from __call__")
        modes = {"call": lambda: [pred(img, xyz) for img, xyz in scenes],
                 "stream_depth1": lambda: list(pred.stream(iter(scenes), depth=1)),
                 "stream_depth2": lambda: list(pred.stream(iter(scenes), depth=2))}
        times = {m: [] for m in modes}
        for _ in range(3):
            for m, fn in modes.items():
                times[m].append(median_ms(fn, reps=1)[0])
        r = results[tag] = {m: {"frames_per_s": frames / statistics.median(t) * 1e3,
                                "ms": statistics.median(t)} for m, t in times.items()}
        sync_print(f"stream_main {tag}: outputs equal to __call__ at depth 1 and 2 "
                   f"({crops} of {frames} frames refined); frames/s "
                   + " ".join(f"{m}={v['frames_per_s']:.2f}" for m, v in r.items()))
        del pred
        preds[tag] = None
        torch.cuda.empty_cache()


def demo_frame_phase():
    """The demo's per-frame function (cli.demo.label_frame) on an in-memory
    full-width frame: the predictor's refined labels, as numpy int32."""
    from unseenobjectswithmeanshift_torch.cli.demo import label_frame

    image, xyz = synthetic_rgbd(seed=0)
    pred = decisive_predictor(seed=0)
    labels, ms = label_frame(pred, image[0], xyz[0])
    want = pred(image, xyz)[1][0].cpu().numpy()
    sync_print(f"demo_frame: label_frame {labels.shape} {labels.dtype} in {ms:.1f} ms, "
               f"{len(set(labels.flatten().tolist())) - 1} instances, equal to the "
               f"predictor's={bool((labels == want).all())}")
    assert labels.shape == (480, 640) and str(labels.dtype) == "int32"
    assert (labels == want).all()


def main(argv=None):
    p = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    p.add_argument("--weights", help="a .npz export of one MSMFormer release "
                   "(scripts/export_release_npz.py): tile_skip_main runs on it too")
    opts = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: disabled for matmul and cudnn (fp32 reference numerics)", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    print(f"nvcc: {_build.nvcc_version()}", flush=True)
    _build.build_all()
    for name, secs in _build.build_seconds.items():
        print(f"build {name}.cu seconds={secs:.2f}", flush=True)
        for line in _build.build_log[name].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print("  " + line.strip(), flush=True)
    phase_done("build", t0)

    # 2. kernel vs plain at the main path's shapes, both positional forms
    t0 = time.perf_counter()
    shapes = {"stage1_B1_K307200": (1, 480, 640, ()),
              "crops_B8_K50176": (8, 224, 224, (3, 6)),
              "crops_B20_K50176": (20, 224, 224, ())}
    results = {}
    for name, s in shapes.items():
        results[name] = {}
        for form in FORMS:
            results[name][form] = {"max_abs_err": check_case(name, *s, form=form)[2]}
            torch.cuda.empty_cache()
    mask_checks = {"stage1_B1_K307200": check_mask_case("stage1_B1_K307200", 1, 480 * 640),
                   "crops_B20_K50176": check_mask_case("crops_B20_K50176", 20, 224 * 224,
                                                       (5, 12))}
    torch.cuda.empty_cache()
    phase_done("check", t0)

    # 3. timing: kernel (both forms), plain, bounds, and the earlier kernel's ms
    t0 = time.perf_counter()
    for name, (B, h, w, absent) in shapes.items():
        for form in FORMS:
            args, present = make_inputs(B, h, w, absent, form=form)
            r = results[name][form]
            r["ms"] = time_ms(lambda: fused_uoms_cross_attention(*args, present=present))
            if form == "separable":   # the plain version expands the factors to posT
                r["plain_ms"] = time_ms(
                    lambda: fused_uoms_cross_attention_plain(*args, present=present))
            tc, fma, nbytes = work(args, present)
            r["bound_ms"], r["bound_by"] = tf32x3_bound(tc, fma, nbytes)
            r["bound_fp32_ms"] = bound(tc + fma, nbytes)[0]
            r.update(gflop=(tc + fma) / 1e9, gbytes=nbytes / 1e9)
            sync_print(f"time {name} {form}: kernel_ms={r['ms']:.3f} (earlier kernel: "
                       f"{EARLIER_XATTN_MS[name]:.3f}) "
                       + (f"plain_ms={r['plain_ms']:.3f} " if "plain_ms" in r else "")
                       + f"bound_ms={r['bound_ms']:.3f} ({r['bound_by']}; 3xTF32 products "
                       f"{tc / 1e9:.1f} GFLOP at {PEAK_3XTF32_FLOPS / 1e12:.0f} TFLOP/s, pos "
                       f"tables {fma / 1e9:.2f} GFLOP at {PEAK_FP32_FLOPS / 1e12:.0f}, "
                       f"{nbytes / 1e9:.3f} GB) bound_fp32_ms={r['bound_fp32_ms']:.3f} "
                       f"achieved={(tc + fma) / r['ms'] / 1e9:.2f} TFLOP/s")
            del args, present
            torch.cuda.empty_cache()
    phase_done("time", t0)

    # 4. two-stage main path at full width
    t0 = time.perf_counter()
    launches = msmformer_main_phase(results, t0)
    torch.cuda.empty_cache()
    phase_done("main", t0)

    # 5-7. the UCN path
    t0 = time.perf_counter()
    ucn_cases, ucn_results = ucn_check_phase()
    phase_done("ucn_check", t0)
    t0 = time.perf_counter()
    ucn_time_phase(ucn_cases, ucn_results)
    del ucn_cases
    torch.cuda.empty_cache()
    phase_done("ucn_time", t0)
    t0 = time.perf_counter()
    cc_spy = ConnectedComponentsSpy()
    with cc_spy:
        ucn_launches = ucn_main_phase(ucn_results)
    phase_done("ucn_main", t0)

    # 8-10. tile skipping and the masked-attention kernels
    t0 = time.perf_counter()
    skip_results = tile_skip_check_phase()
    phase_done("tile_skip_check", t0)
    t0 = time.perf_counter()
    skip_main = {}
    skip_launches = tile_skip_main_phase(skip_main, opts.weights)
    torch.cuda.empty_cache()
    phase_done("tile_skip_main", t0)
    t0 = time.perf_counter()
    mattn_launches, mattn_results, mattn_regs = masked_attention_phase()
    phase_done("masked_attention", t0)

    # 11-18. the UCN-family configurations and serving entry points
    t0 = time.perf_counter()
    stride_results = key_stride_check_phase()
    phase_done("key_stride_check", t0)
    t0 = time.perf_counter()
    cat_results = cat_check_phase()
    phase_done("cat_check", t0)
    t0 = time.perf_counter()
    preset_results = {}
    with cc_spy:
        preset_launches = presets_main_phase(preset_results)
    phase_done("presets_main", t0)
    t0 = time.perf_counter()
    grouped_results = {}
    grouped_towers_phase(grouped_results)
    phase_done("grouped_towers", t0)
    t0 = time.perf_counter()
    no_sync = stage1_no_sync_phase()
    phase_done("stage1_no_sync", t0)
    t0 = time.perf_counter()
    stream_results = {}
    with cc_spy:
        stream_main_phase(stream_results)
    phase_done("stream_main", t0)
    t0 = time.perf_counter()
    demo_frame_phase()
    phase_done("demo_frame", t0)
    t0 = time.perf_counter()
    cc_results = cc_check_phase(cc_spy)
    phase_done("cc_check", t0)

    s1r = results["stage1_B1_K307200"]["separable"]
    kernels = [{
        "name": "fused_uoms_cross_attention",
        "route": "cuda",
        "source": "unseenobjectswithmeanshift_torch/csrc/fused_cross_attention.cu",
        "replaces": "unseenobjectswithmeanshift_tpu/ops/fused_cross_attention.py:334",
        "launches": launches,
        "max_abs_err": max(x["max_abs_err"] for r in results.values() for x in r.values()),
        "ms": s1r["ms"], "plain_ms": s1r["plain_ms"], "bound_ms": s1r["bound_ms"],
        "bound_by": s1r["bound_by"], "library_ms": None,
        "ms_general_pos": results["stage1_B1_K307200"]["general"]["ms"],
        "bound_fp32_ms": s1r["bound_fp32_ms"],
        "shapes": results, "mask_checks": mask_checks,
        "key_stride_shapes": stride_results,
        "launches_key_stride": {k: preset_launches[k]["fused_uoms_cross_attention"]
                                for k in ("key_stride_2", "key_stride_3")},
    }]
    u1 = ucn_results["stage1_B1_N307200"]
    for name, line, err_key, design in (
            ("fps_seeds", 242, "fps_max_gap",
             "one persistent cooperative launch a call, grid barrier a step; running "
             "distances and part of X held on chip (shared memory, registers)"),
            ("mean_shift_seeds", 127, "climb_max_abs_err",
             "the FPS kernel, then hill climbing on wgmma in 3xTF32 (csrc/mean_shift_climb.cu)")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "unseenobjectswithmeanshift_torch/csrc/"
                      + ("fps_seeds.cu" if name == "fps_seeds" else "mean_shift_climb.cu"),
            "design": design,
            "replaces": f"unseenobjectswithmeanshift_tpu/ops/pallas_mean_shift.py:{line}",
            "launches": sum(p[name] for p in ucn_launches.values()),
            "launches_by_path": {p: v[name] for p, v in ucn_launches.items()},
            "max_abs_err": max(r[err_key] for r in ucn_results.values()),
            "max_abs_err_of": ("gap to the fp64 argmax of the running minimum distance"
                               if name == "fps_seeds" else
                               "climbed seeds vs fp64, clustered and random rows"),
            **{k: u1[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
            "shapes": {k: {**{e: v for e, v in r.items() if not isinstance(v, dict)},
                           **r.get(name, {})} for k, r in ucn_results.items()},
            "d128_shapes": {k: {**{e: v for e, v in r.items() if not isinstance(v, dict)},
                                **r.get(name, {})}
                            for k, r in {**cat_results, **{
                                k: v for k, v in preset_results.items()
                                if k.startswith("d128_")}}.items()},
            "launches_d128": preset_launches["ucn_rgbd_cat"][name],
        })
    u1cc = ucn_results["stage1_B1_N307200"]
    kernels.append({
        "name": "connected_components",
        "route": "cuda",
        "source": "unseenobjectswithmeanshift_torch/csrc/connected_components.cu",
        "replaces": "none: no TPU kernel (the JAX package runs this sweep in XLA, "
                    "unseenobjectswithmeanshift_tpu/ops/mean_shift.py:81)",
        "launches": sum(p["connected_components"] for p in ucn_launches.values()),
        "launches_by_path": {p: v["connected_components"] for p, v in ucn_launches.items()},
        "max_abs_err": 0 if cc_results["equal"] else None,
        "max_abs_err_of": f"labels equal to the numpy sweep on {cc_results['images']} images",
        "ms": u1cc["connected_components_ms"],
        "plain_ms": u1cc["connected_components_host_ms"],
        # S^2 adjacency bytes in, S labels out, a B=1 call
        "bound_ms": (SEEDS * SEEDS + 4 * SEEDS) / PEAK_BYTES * 1e3, "bound_by": "bytes",
        "library_ms": None,
        "shapes": {**{k: {"ms": r["connected_components_ms"],
                          "plain_ms": r["connected_components_host_ms"]}
                      for k, r in ucn_results.items() if "connected_components_ms" in r},
                   **{k: v for k, v in cc_results.items() if isinstance(v, dict)}},
    })
    s1k = skip_results["stage1_B1_K307200_concentrated"]
    kernels.append({
        "name": "fused_uoms_cross_attention(tile_skip=True)",
        "route": "cuda",
        "source": "unseenobjectswithmeanshift_torch/csrc/fused_cross_attention.cu",
        "replaces": "unseenobjectswithmeanshift_tpu/ops/fused_cross_attention.py:483",
        "launches": skip_launches,
        "max_abs_err": max(r["max_abs_err"] for r in skip_results.values()),
        **{k: s1k[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "shapes": skip_results,
        "main_path": skip_main,
    })
    for name, line in (("masked_hypersphere_attention", 90),
                       ("fused_masked_hypersphere_attention", 245)):
        r = mattn_results[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "unseenobjectswithmeanshift_torch/csrc/masked_attention.cu",
            "design": MATTN_DESIGN[name],
            "replaces": f"unseenobjectswithmeanshift_tpu/ops/pallas_attention.py:{line}",
            "launches": mattn_launches[name],
            "launches_of": "driven directly by the masked_attention phase: no model calls it",
            "max_abs_err": max(x["max_abs_err"] for x in r.values()),
            **{k: r["stage1_B1_K307200"][k]
               for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                         "bound_fp32_ms")},
            "ptxas": {k: v for k, v in mattn_regs.items()
                      if k.startswith("mha" if name.startswith("masked") else "fused")},
            "shapes": r,
        })
    print(json.dumps({"presets_main": preset_results, "grouped_towers": grouped_results,
                      "stream_main": stream_results, "stage1_no_sync": no_sync}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
