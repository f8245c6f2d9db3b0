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
            1xTF32 would fail it). Then the sizes past one launch of each
            kernel: FPS at B=160 crops (8 frames x 20), which runs in
            groups of whole images, one launch each (fps_plan): the images
            on both sides of each group boundary through the fp64 gate, and
            launched together in one call with the same indices; and 200
            seeds (two blocks of the climbing kernel, a wider block of the
            connected components): FPS and climbing against fp64, the
            components equal to the numpy sweep.
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
            ms dense / skipping / force_all on each layer's own inputs (and
            bf16_main compares bf16 with fp32 on them).
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
19. bf16_check  the cross-attention's bf16 variant (all inputs and the
            output bf16, the JAX package's serving dtype) against its plain
            twin on the same bf16 inputs (BF16_TOL) at B=1/K=307,200,
            B=8/K=50,176 (2 absent), B=20/K=50,176 and the key_stride 3
            crops (B=20, K=5,625), both positional forms, guard queries;
            the mask pass alone on bf16 operands against the fp64 signs
            outside MASK_MARGIN; tile skipping equal to dense (torch.equal)
            on concentrated masks; kernel, twin, fp32 kernel and bound ms
            (products at the bf16 tensor rate); ptxas registers.
20. bf16_main  the two-stage MSMFormer with bf16=True at full width on the
            decisive weights, at B=1 and B=8 frames: 6 + 6 bf16 launches a
            frame, the model surface against fp32 on the same weights and
            frames, label agreement, crops, e2e in turns with fp32 and the
            bf16 breakdown; the bf16 path with decoder.tile_skip equal to
            the dense bf16 path; one UCN frame with bf16 SEGNETs; with
            --weights, the B=1 comparison on those weights. Phases 15 and
            16 run the bf16 MSMFormer predictor too.
21. r50_check  rows 1-2 at the key counts of the standard-backbone pyramid
            (K = 300, 1,200, 4,800 at B=1; K = 49, 196, 784 at B=20 with
            2 crops absent): fp32 against fp64 (TOL) and bf16 against its
            twin (BF16_TOL) in both positional forms, tile skipping equal to
            dense (torch.equal) in both dtypes; launches, kernel, plain and
            bound ms at each shape.
22. r50_main  tabletop_pretrained_resnet50 + crop_tabletop_resnet50_rgb at
            full width (ResNet50, MSDeformAttn pixel decoder, 9-layer 3-level
            decoder), 480x640, B=1, fp32, decisive weights: 9 + 9
            cross-attention launches, >= 1 crop, the network against its
            CPU copy on a 96x128 input (R50_CPU_TOL), e2e, breakdown, peak
            memory, the kernel again at the crop count stage 2 ran; the same
            frame with bf16=True against fp32; one frame each of
            tabletop_swin, pushing_resnet50 (with depth), uoais_resnet50 and
            mixture_resnet50 in fp32 and in bf16, 9 + 9 launches each.
23. train_check  one train step (forward and backward) of the full-width
            tabletop_pretrained network at 96x128, B=2, on a batch the port's
            renderer made on the card, against a CPU copy on the same
            weights, batch and draws: every loss term and the global
            gradient norm (TRAIN_CPU_TOL); the chunked two-pass training
            attention at K=40,000 (past 32,768) in fp32 against the dense
            masked attention in fp64, output and every gradient
            (TWOPASS_TOL); a NaN-poisoned batch skipped with the parameters,
            running statistics and optimizer state unchanged (torch.equal).
24. train_main  training at full width through Trainer: the whole-image
            network, B=4 at 480x640 from SyntheticDeviceLoader, 8 steps on a
            fixed batch (median step ms after 2 warm-ups, every loss term,
            peak memory, skips; gates: finite, the loss falls); the same for
            the crop network on 224^2 SYN_CROP crops; 3 bf16 steps, step 0's
            loss within 5% of fp32's on the same weights and batch; both
            networks saved with checkpoint_io, restored, and served through
            build_two_stage_predictor(checkpoint=...) on one 480x640 frame
            (6 + 6 cross-attention launches; stage 2 refines main's decisive
            stage-1 crops of the frame when the briefly trained network
            finds no instance in it). With --weights,
            8 fine-tuning steps from them, beside the release's logged
            losses (no gate).
25. eval_check  the evaluation path's host code, with cv2 and PIL made
            unimportable for phases 25-27 (the card machine may have them):
            the native host library built by g++ from the port's
            source (its seconds); every PNG colour type and bit depth through
            the port's encoder with each row filter forced, decoded by both
            backends to the written samples; ascii, binary and
            binary_compressed PCD clouds at 480x640 with NaN read back in
            both backends (native LZF equal to the Python LZF and to the
            written bytes); multilabel_metrics native equal to numpy on 16
            seeded 480x640 label pairs (an empty prediction, an empty ground
            truth, tied overlaps), ms an image of each.
26. eval_main  an OCID-layout tree of 16 frames ('table' and floor
            sequences, paletted labels with table id 1 and floor id 2,
            binary_compressed clouds) and an OSD-layout tree of 8, written
            from scenes the port renders on the card (scene_style "ocid");
            every sample the readers return equal to the frame written;
            cli.test_net.evaluate at B=4 on decisive_predictor in fp32
            (OCID, and OSD over 7 frames: a short last batch) and bf16, and
            on the decisive UCN predictor (14 frames): 6 + 6 cross-attention
            launches a batch (bf16: 6 + 6 bf16), 1 + 1 FPS and connected
            components launches a UCN batch (stage 2 only where crops are
            present, at least one such batch), the labels scored equal to
            pred(image, xyz) on each batch (torch.equal); the metric block,
            img/s with and without the host metrics, the host's ms an image.
            Then cli.test_net.main through its argv on the OCID tree (random
            weights; with --weights also the release paired with itself; no
            quality gate).
27. train_eval  cli.train_msmformer at 480x640, B=4, 4 steps with
            --eval-period 2 --eval-samples 8: two finite eval records; then
            its evaluate_scenes on decisive_predictor's whole-image network
            over the same 8 held-out scenes, equal to the serving path's
            stage-1 labels of each scene scored by multilabel_metrics, with
            at least one object detected.

The line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Any failure ends the run with a
traceback and a non-zero exit code. Without CUDA the script fails at once.
"""

import argparse
import contextlib
import copy
import heapq
import json
import os
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from unseenobjectswithmeanshift_torch.config import get_config
from unseenobjectswithmeanshift_torch.data.synthetic_device import SyntheticDeviceLoader
from unseenobjectswithmeanshift_torch.models import decoder as decoder_module
from unseenobjectswithmeanshift_torch.models.position_encoding import position_embedding_sine
from unseenobjectswithmeanshift_torch.ops import _build
from unseenobjectswithmeanshift_torch.ops.fused_cross_attention import (
    TILE_KEYS, fused_uoms_cross_attention, fused_uoms_cross_attention_plain, launch_plan,
    mask_pass, tile_occupancy, unmasked_keys,
)
from unseenobjectswithmeanshift_torch.ops.hypersphere_attention import (
    bool_mask_to_bias, chunked_masked_meanshift_attention_twopass, meanshift_attention,
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
from unseenobjectswithmeanshift_torch.train.trainer import Trainer, new_model
from unseenobjectswithmeanshift_torch.utils import checkpoint_io
from unseenobjectswithmeanshift_torch.utils.preprocess import compute_xyz
from unseenobjectswithmeanshift_torch.weights import from_jax_variables, load_npz_variables

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
              + present.numel() + qn.numel() * qn.element_size()
              - (B * K - k_img) * C * featT.element_size())
    if isinstance(pos, tuple):
        fma = 2 * (pos[0].shape[1] + pos[1].shape[1]) * (E // 2) * E
    else:
        fma = 2 * k_any * E * E
        nbytes -= (K - k_any) * E * pos.element_size()
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


def check_mask_case(name, B, K, absent=(), dtype=torch.float32):
    """The mask pass alone on mask_inputs(B, K) (rounded to `dtype`), held
    by mask_mismatches to the fp64 logits of those operands; raises on a bad
    bit or count. -> the mismatch dict."""
    me, mfT = (t.to(dtype) for t in mask_inputs(B, K))
    present = torch.ones(B, dtype=torch.bool, device="cuda")
    for b in absent:
        present[b] = False
    bits, cnt = mask_pass(me, mfT, present)
    r = mask_mismatches(bits, cnt, me, mfT, present)
    absent_zero = all(bool((bits[b] == 0).all() and (cnt[b] == 0).all()) for b in absent)
    guard = bool((cnt[present][:, :4] == 0).all())
    sync_print(f"check mask {name} {str(dtype)[6:]}: bad={r['bad']} (keys beyond the margin "
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


def fps_gate(X, first, seeds, idx, groups, pidx=None):
    """The FPS gates on the kernel's (seeds, idx) [B, S] of X [B, N, d]: per
    step the gap between the fp64 maximum of the running minimum distance
    (from the kernel's own earlier seeds) and the kernel's pick; seeds equal
    to X[idx] bit for bit; the chains start at `first`; identical rows (the
    isolated `groups`) taken at their lowest index. With the fp32 plain
    version's indices `pidx`, also the first step where it departs and the
    fp64 gap there. -> dict."""
    B, S = idx.shape
    rows = torch.arange(B, device="cuda")
    idx_l = idx.long()
    bit_exact = torch.equal(seeds, X[rows[:, None], idx_l])
    starts = torch.equal(idx[:, 0], first)
    departs = [] if pidx is None else (idx != pidx).any(0).nonzero().flatten().tolist()
    dep = departs[0] if departs else None
    X64 = X.double()
    mind, gaps, dep_gap = None, [], None
    for i in range(S):
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
    step = torch.where(hit.any(1), hit.int().argmax(1), S)          # [B, 8, 3]
    tie_ok = bool((step[..., 1:].amin(-1) >= step[..., 0]).all())
    reached = int((step[..., 0] < S).sum())
    del X64, mind
    return dict(max_gap=max_gap, bit_exact=bit_exact, starts=starts, tie_ok=tie_ok,
                reached=reached, dep=dep, dep_gap=dep_gap,
                ok=max_gap <= FPS_TOL and bit_exact and starts and tie_ok)


def check_fps(name, X, first, groups, S=SEEDS):
    """FPS kernel per step against fp64, ties, and the departure from the
    fp32 plain version; raises on a failure. -> (seeds, indices, max gap)."""
    seeds, idx = fps_seeds(X, first, S)
    _, pidx = fps_seeds_plain(X, first, S)
    r = fps_gate(X, first, seeds, idx, groups, pidx)
    dep = r["dep"]
    sync_print(f"ucn_check fps {name}: max_gap_vs_fp64={r['max_gap']:.3e} (tol={FPS_TOL:.0e}) "
               f"seeds_bit_exact={r['bit_exact']} first_ok={r['starts']} "
               f"tie_groups_reached={r['reached']} ties_to_lowest={r['tie_ok']} "
               "departs_from_fp32_plain="
               + (f"step {dep} gap_fp64={r['dep_gap']:.3e}" if dep is not None else "never"))
    if not r["ok"]:
        raise AssertionError(f"FPS kernel disagrees with its plain version at {name}")
    return seeds, idx, r["max_gap"]


def check_climb(name, X, first, seeds, idx, S=SEEDS):
    """Hill-climbing kernel against its plain version in fp64, from the
    kernel's own FPS seeds; raises on a failure. -> max abs error."""
    Z, zidx = mean_shift_seeds(X, first, KAPPA, S, ITERS)
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


def ptxas_entries(source):
    """[(mangled entry function, registers, spill store bytes)] from nvcc's
    -Xptxas=-v log of csrc/<source>.cu."""
    out, sym = [], None
    for line in _build.build_log.get(source, "").splitlines():
        if "Compiling entry function" in line:
            sym, spill = line.split("'")[1], 0
        elif sym and "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif sym and "Used" in line and "registers" in line:
            out.append((sym, int(line.split("Used ")[1].split(" registers")[0]), spill))
            sym = None
    return out


def ptxas_report(source, kernels):
    """{kernel: {"registers": n, "spill_bytes": stores}} of the entry
    functions of csrc/<source>.cu whose name holds one of `kernels`
    (template variants kept apart by their mangled arguments)."""
    report = {}
    for sym, regs, spill in ptxas_entries(source):
        k = next((k for k in kernels if k in sym), None)
        if k is None:
            continue
        args = re.match(r"I((?:Lb[01]E)+)E", sym[sym.index(k) + len(k):])
        name = k + (f"<{','.join(re.findall(r'Lb([01])E', args.group(1)))}>" if args else "")
        report[name] = {"registers": regs, "spill_bytes": spill}
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
    fused_uoms_cross_attention.bf16_launches = 0
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
             "msmformer_bf16": decisive_predictor(seed=0, bf16=True),
             "ucn": decisive_ucn_predictor(image, xyz, seed=0),
             "ucn_bf16": decisive_ucn_predictor(image, xyz, seed=0, bf16=True)}
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
             "msmformer_bf16": decisive_predictor(seed=0, bf16=True),
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



# bf16, the JAX package's serving dtype (bench.py:86-88). The bf16 kernel is
# held to its plain twin on the same bf16 inputs: both round k^, the weights
# and v to bf16 and sum in fp32, in other orders (the twin on cuBLAS fp32
# products of the bf16 values, the kernel on mma.sync with fp32
# accumulation, its weights from ex2.approx), so a rounding of k^ or of a
# weight can fall the other way: a few bf16 ulps (2^-8 at outputs below 1).
# BF16_TOL is the JAX package's own gate for its compiled bf16 kernel
# against its reference (bench.py:99-123); an indexing or masking fault
# shows as O(0.1). The mask logits of make_inputs are exact in bf16 too, so
# both sides mask the same keys; the mask pass alone is held to the fp64
# signs of its bf16 operands outside MASK_MARGIN (products of bf16 values
# are exact in fp32, as the 3xTF32 products are nearly).
BF16_TOL = 2e-2
PEAK_BF16_FLOPS = 989e12   # H100 SXM bf16 tensor cores, dense
BF16_SHAPES = {"stage1_B1_K307200": (1, 480, 640, ()),
               "crops_B8_K50176": (8, 224, 224, (3, 6)),
               "crops_B20_K50176": (20, 224, 224, ()),
               "stride3_crops_B20_K5625": (20, 75, 75, ())}


def to_bf16(args):
    """The inputs rounded to bf16 (either positional form)."""
    return [tuple(t.bfloat16() for t in a) if isinstance(a, tuple) else a.bfloat16()
            for a in args]


def bf16_bound(tc, fma, nbytes):
    """(bound ms, what bounds it) of the bf16 kernel: `tc` operations of
    products at the bf16 tensor rate plus `fma` on the fp32 pipe (the pos
    tables), against the bytes over the memory rate."""
    t_ops = tc / PEAK_BF16_FLOPS + fma / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def xattn_ptxas():
    """{variant: {"registers", "spill_bytes"}} of the cross-attention's
    attention and mask passes, fp32 and bf16."""
    report = {}
    for sym, regs, spill in ptxas_entries("fused_cross_attention"):
        kind = next((k for k in ("xattn_partial_kernel", "mask_kernel_bf16", "mask_kernel")
                     if k in sym), None)
        if kind is None:
            continue
        tail = sym[sym.index(kind) + len(kind):]
        dtype = "bf16" if "bfloat16" in tail or kind == "mask_kernel_bf16" else "fp32"
        mode = re.search(r"Li(\d)E", tail)
        vec = re.findall(r"Lb([01])E", tail)
        name = (f"{kind.replace('_bf16', '')}<{dtype}" + (f",mode={mode.group(1)}" if mode else "")
                + (f",vec={vec[-1]}" if vec else "") + ">")
        report[name] = {"registers": regs, "spill_bytes": spill}
    return report


def check_bf16_case(name, B, h, w, absent=(), form="separable"):
    """The bf16 kernel against its twin on make_inputs rounded to bf16; the
    fp32 kernel on the unrounded inputs beside it. Raises on a failure.
    -> (args, present, results)."""
    args32, present = make_inputs(B, h, w, absent, form=form)
    args = to_bf16(args32)
    got = fused_uoms_cross_attention(*args, present=present)
    want = fused_uoms_cross_attention_plain(*args, present=present)
    got32 = fused_uoms_cross_attention(*args32, present=present)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    dev = (got.float() - got32).abs().max().item()
    scale = got32.abs().max().item()
    guard_rows = int(((args32[3] @ args32[2]) < 0).all(-1).sum())
    finite = bool(torch.isfinite(got).all())
    absent_zero = all(bool((got[b] == 0).all()) for b in absent)
    ok = (got.dtype == torch.bfloat16 and err <= BF16_TOL and finite and absent_zero
          and guard_rows > 0)
    del got, want, got32, args32
    sync_print(f"bf16_check {name} {form}: max_abs_err={err:.3e} (vs the bf16 twin, "
               f"tol={BF16_TOL:.0e}) vs_fp32_kernel={dev:.3e} (output scale {scale:.3f}) "
               f"guard_rows={guard_rows} finite={finite} absent_zero={absent_zero}")
    if not ok:
        raise AssertionError(f"bf16 kernel disagrees with its twin at {name} {form}")
    return args, present, {"max_abs_err": err, "vs_fp32_kernel": dev}


def bf16_check_phase():
    """19. the bf16 kernel: against its twin at BF16_SHAPES in both
    positional forms, the mask pass alone on bf16 operands, tile skipping
    equal to dense (torch.equal), kernel / twin / fp32 kernel / bound ms and
    ptxas registers. -> {case: results}."""
    results = {"ptxas": xattn_ptxas()}
    for kname, r in results["ptxas"].items():
        sync_print(f"bf16_check ptxas {kname}: registers={r['registers']} "
                   f"spill_bytes={r['spill_bytes']}")
    for name, (B, h, w, absent) in BF16_SHAPES.items():
        r = results[name] = {}
        for form in FORMS:
            args, present, r[form] = check_bf16_case(name, B, h, w, absent, form)
            if form == "separable":
                args32 = make_inputs(B, h, w, absent)[0]
                ms = time_in_turns({
                    "bf16": lambda: fused_uoms_cross_attention(*args, present=present),
                    "fp32": lambda: fused_uoms_cross_attention(*args32, present=present)})
                plain_ms = time_ms(lambda: fused_uoms_cross_attention_plain(
                    *args, present=present), warmup=1, reps=3)
                tc, fma, nbytes = work(args, present)
                bound_ms, bound_by = bf16_bound(tc, fma, nbytes)
                r[form].update(ms=ms["bf16"], fp32_kernel_ms=ms["fp32"], plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by, gflop=(tc + fma) / 1e9,
                               gbytes=nbytes / 1e9)
                sync_print(f"bf16_check time {name}: kernel_ms={ms['bf16']:.3f} "
                           f"fp32_kernel_ms={ms['fp32']:.3f} twin_ms={plain_ms:.3f} "
                           f"bound_ms={bound_ms:.4f} ({bound_by}; products {tc / 1e9:.1f} "
                           f"GFLOP at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, pos tables "
                           f"{fma / 1e9:.2f} GFLOP at {PEAK_FP32_FLOPS / 1e12:.0f}, "
                           f"{nbytes / 1e9:.3f} GB) share_of_bound={bound_ms / ms['bf16']:.3f}")
                del args32
            del args, present
            torch.cuda.empty_cache()
        if name != "crops_B8_K50176":
            r["mask"] = check_mask_case(name, B, h * w, absent, dtype=torch.bfloat16)
    # tile skipping in bf16: equal to dense, timed on concentrated masks
    for name, (B, h, w, absent, guards, conc) in TILE_SKIP_CASES.items():
        if not conc:
            continue
        args32, present = concentrated_inputs(B, h, w, absent, guards)
        args = to_bf16(args32)
        call = lambda **kw: fused_uoms_cross_attention(*args, present=present, **kw)
        dense, skip = call(), call(tile_skip=True)
        equal = torch.equal(skip, dense)
        err = (skip.float() - fused_uoms_cross_attention_plain(
            *args, present=present, tile_skip=True).float()).abs().max().item()
        share, occ = skipped_share(args32[3], args32[2], present)
        del dense, skip
        ms = time_in_turns({"skip": lambda: call(tile_skip=True), "dense": call})
        plain_ms = time_ms(lambda: fused_uoms_cross_attention_plain(
            *args, present=present, tile_skip=True), warmup=1, reps=3)
        tc, fma, nbytes = work(args, present, occ)
        bound_ms, bound_by = bf16_bound(tc, fma, nbytes)
        results["tile_skip_" + name] = dict(
            equal_to_dense=equal, max_abs_err=err, skipped_share=share, ms=ms["skip"],
            dense_ms=ms["dense"], plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        sync_print(f"bf16_check tile_skip {name}: equal_to_dense={equal} max_abs_err={err:.3e} "
                   f"(vs the twin) skipped_share={share:.4f} kernel_ms skip={ms['skip']:.3f} "
                   f"dense={ms['dense']:.3f} twin_ms={plain_ms:.3f} bound_ms={bound_ms:.4f} "
                   f"({bound_by})")
        if not (equal and err <= BF16_TOL):
            raise AssertionError(f"bf16 tile skipping disagrees at {name}")
        del args, args32, present, occ
        torch.cuda.empty_cache()
    return results


def surface_deviation(out32, out16):
    """The bf16 model surface against fp32 on the same weights and input,
    as the JAX package's tests/test_factory.py:170-176 measures it: max
    |a - b| over the fp32 scale, and the sign agreement where |a| > 0.1 of
    the scale; for pred_logits, mask_embed and the masks mask_embed .
    mask_features. Logits that are the same constant everywhere (the
    decisive weights zero the class kernel) have no scale and are left out."""
    masks = lambda o: torch.einsum("bqc,bhwc->bqhw", o["mask_embed"].float(),
                                   o["mask_features"].float())
    r = {}
    for key, a, b in (("pred_logits", out32["pred_logits"], out16["pred_logits"].float()),
                      ("mask_embed", out32["mask_embed"], out16["mask_embed"].float()),
                      ("pred_masks", masks(out32), masks(out16))):
        if bool((a == a.flatten()[0]).all()):
            continue
        scale = a.abs().max()
        conf = a.abs() > 0.1 * scale
        r[key] = {"max_dev_of_scale": ((a - b).abs().max() / scale).item(),
                  "sign_agreement": (a[conf].sign() == b[conf].sign()).float().mean().item()}
    return r


def label_agreement(a, b):
    """How far two label images [B, H, W] (0 background) agree, whatever
    their numbering: the share of pixels on which they agree about
    foreground, and the mean over a's instances of the best IoU with an
    instance of b (1 when b has the same segments)."""
    fg = ((a > 0) == (b > 0)).float().mean().item()
    best = []
    for x, y in zip(a, b):
        V = int(max(x.max(), y.max())) + 1
        inter = torch.bincount((x.long() * V + y.long()).flatten(), minlength=V * V)
        inter = inter.reshape(V, V)[1:, 1:].double()
        area_x = torch.bincount(x.flatten().long(), minlength=V)[1:].double()
        area_y = torch.bincount(y.flatten().long(), minlength=V)[1:].double()
        iou = inter / (area_x[:, None] + area_y[None, :] - inter).clamp_min(1)
        best += iou.amax(1)[area_x > 0].tolist() if iou.numel() else []
    return {"foreground": fg, "mean_best_iou": statistics.mean(best) if best else 1.0}


def run_counted(pred, image, xyz):
    """(stage-1 result, refined labels, launches stage 1, stage 2, bf16
    launches stage 1, stage 2) of one driven frame, counts zeroed before."""
    zero_counts()
    s1 = pred.stage1(image, xyz)
    torch.cuda.synchronize()
    n1, b1 = fused_uoms_cross_attention.launches, fused_uoms_cross_attention.bf16_launches
    refined = pred.refine(s1)
    torch.cuda.synchronize()
    return (s1, refined, n1, fused_uoms_cross_attention.launches - n1, b1,
            fused_uoms_cross_attention.bf16_launches - b1)


def backbone_fn(model, image, xyz):
    """The whole-image network's backbone alone: the SEGNET, or the standard
    arch's ResNet50 / Swin on the COCO-normalized image."""
    if hasattr(model, "pretrained_backbone"):
        return lambda: model.pretrained_backbone(image, xyz)
    return lambda: model.backbone_features(image)


def compare_dtypes(tag, p32, p16, image, xyz):
    """bf16 predictor against fp32 on the same weights and frames: launches
    (one a decoder layer and stage, all bf16: 6 + 6 for the UCN-backbone
    decoder, 9 + 9 for the 3-level one), surface deviation, label
    agreement, crops, e2e in turns (fp32, bf16, bf16, fp32) and the bf16
    breakdown. -> results."""
    s1, refined, n1, n2, b1, b2 = run_counted(p16, image, xyz)
    crops = int(sum(int(c.present.sum()) for c in s1.crops))
    nl = p16.model.sem_seg_head.predictor.L
    assert (n1, n2, b1, b2) == (nl,) * 4, f"{tag}: launches {n1} + {n2}, bf16 {b1} + {b2}"
    assert crops >= 1, f"{tag}: stage 1 gave no crop, so stage 2 did not run"
    B = image.shape[0]
    assert s1.labels.shape == refined.shape == (B, 480, 640)
    assert s1.labels.dtype == refined.dtype == torch.int32
    l32, r32 = p32(image, xyz)
    s32 = p32.stage1(image, xyz)
    crops32 = int(sum(int(c.present.sum()) for c in s32.crops))
    with torch.inference_mode():
        o32, o16 = (p.model(image, xyz, light=True) for p in (p32, p16))
    finite = all(bool(torch.isfinite(o16[k]).all())
                 for k in ("pred_logits", "mask_embed", "mask_features"))
    assert finite and o16["pred_logits"].dtype == torch.bfloat16, f"{tag}: bf16 outputs"
    dev = surface_deviation(o32, o16)
    del o32, o16
    agree = {"labels": label_agreement(l32, s1.labels),
             "refined": label_agreement(r32, refined)}
    e2e = {}
    for name, pred in (("fp32", p32), ("bf16", p16), ("bf16", p16), ("fp32", p32)):
        e2e.setdefault(name, []).extend(median_ms(lambda: pred(image, xyz))[1])
    med = {k: statistics.median(v) for k, v in e2e.items()}
    with torch.inference_mode():
        parts = {"stage1_backbone": backbone_fn(p16.model, image, xyz),
                 "stage1_network": lambda: p16.model(image, xyz, light=True),
                 "stage1_total": lambda: p16.stage1(image, xyz),
                 "refine_total": lambda: p16.refine(s1)}
        split = {k: median_ms(f)[0] for k, f in parts.items()}
    sync_print(f"{tag}: launches stage1={n1} stage2={n2} (bf16 {b1} + {b2}) crops bf16={crops} "
               f"fp32={crops32} for {B} frame(s); surface vs fp32 "
               + " ".join(f"{k} dev={v['max_dev_of_scale']:.3e} sign={v['sign_agreement']:.4f}"
                          for k, v in dev.items())
               + "; agreement with fp32 (foreground share / mean best IoU) "
               + " ".join(f"{k}={v['foreground']:.4f}/{v['mean_best_iou']:.4f}"
                          for k, v in agree.items())
               + f"; e2e_ms median of 6 bf16={med['bf16']:.1f} fp32={med['fp32']:.1f} (per frame "
               f"{med['bf16'] / B:.1f} / {med['fp32'] / B:.1f}); bf16 breakdown median ms "
               + " ".join(f"{k}={v:.1f}" for k, v in split.items()))
    return dict(launches=n1 + n2, bf16_launches=b1 + b2, crops_bf16=crops, crops_fp32=crops32,
                surface=dev, label_agreement=agree, e2e_ms=med, breakdown_ms=split,
                runs_ms=e2e)


def bf16_main_phase(results, weights=None):
    """20. the two-stage MSMFormer in bf16 at full width through the factory
    (bf16=True), on the decisive weights of main, at B=1 and B=8 frames,
    against fp32 on the same weights (compare_dtypes); the bf16 path with
    decoder.tile_skip against the dense bf16 path (compare_paths); one UCN
    frame with bf16 SEGNETs (launches, labels, e2e beside fp32); with
    --weights, the two-stage comparison on those weights. -> launches of the
    bf16 kernel in the B=1 dense and tile-skipping frames."""
    image, xyz = synthetic_rgbd(seed=0)
    p32, p16 = decisive_predictor(seed=0), decisive_predictor(seed=0, bf16=True)
    results["B1"] = compare_dtypes("bf16_main B1", p32, p16, image, xyz)
    launches = results["B1"]["bf16_launches"]
    scenes = [synthetic_rgbd(seed=i) for i in range(8)]
    img8, xyz8 = (torch.cat([sc[i] for sc in scenes]) for i in (0, 1))
    del scenes
    results["B8"] = compare_dtypes("bf16_main B8", p32, p16, img8, xyz8)
    del img8, xyz8
    torch.cuda.empty_cache()
    skip = decisive_predictor(seed=0, bf16=True, tile_skip=True)
    skip_launches, log, _ = compare_paths("bf16_main tile_skip", p16, skip, image, xyz)
    results["tile_skip"] = dict(launches=skip_launches, skipped_share=[e[0] for e in log])
    del p32, p16, skip, log
    torch.cuda.empty_cache()

    u32 = decisive_ucn_predictor(image, xyz, seed=0)
    u16 = decisive_ucn_predictor(image, xyz, seed=0, bf16=True)
    zero_counts()
    s1 = u16.stage1(image, xyz)
    torch.cuda.synchronize()
    n1 = kernel_counts()
    refined = u16.refine(s1)
    torch.cuda.synchronize()
    n2 = {k: v - n1[k] for k, v in kernel_counts().items()}
    crops = int(sum(int(c.present.sum()) for c in s1.crops))
    want = {"fused_uoms_cross_attention": 0, "fps_seeds": 1, "mean_shift_seeds": 0,
            "connected_components": 1}
    assert n1 == want and n2 == want, f"ucn bf16: launches {n1} + {n2}"
    assert crops >= 1 and refined.shape == (1, 480, 640) and refined.dtype == torch.int32
    with torch.inference_mode():
        f16 = u16.network(image, xyz)
        f32 = u32.network(image, xyz)
    emb_dev = (f16.float() - f32).abs().max().item()
    l32, r32 = u32(image, xyz)
    e2e = {}
    for name, pred in (("fp32", u32), ("bf16", u16), ("bf16", u16), ("fp32", u32)):
        e2e.setdefault(name, []).extend(median_ms(lambda: pred(image, xyz))[1])
    med = {k: statistics.median(v) for k, v in e2e.items()}
    results["ucn"] = dict(crops=crops, clusters=int(s1.n_clusters[0]), embedding_dev=emb_dev,
                          label_agreement=label_agreement(r32, refined), e2e_ms=med,
                          launches_stage1=n1, launches_stage2=n2)
    sync_print(f"bf16_main ucn: features {f16.dtype}, max |bf16 - fp32| {emb_dev:.3e}; launches "
               f"stage1={n1} stage2={n2}; stage1_clusters={int(s1.n_clusters[0])} "
               f"present_crops={crops}; refined labels against fp32 (foreground share / mean "
               f"best IoU) {results['ucn']['label_agreement']['foreground']:.4f}/"
               f"{results['ucn']['label_agreement']['mean_best_iou']:.4f}; e2e_ms median of 6 "
               f"bf16={med['bf16']:.1f} fp32={med['fp32']:.1f}")
    del u32, u16, s1, refined, f16, f32
    torch.cuda.empty_cache()
    if weights is not None:
        variables = load_npz_variables(weights)
        if "scene" in variables:
            image, xyz = (torch.from_numpy(variables["scene"][k]).cuda() for k in ("image", "xyz"))
        preds = [build_two_stage_predictor(variables=variables, variables_crop=variables,
                                           bf16=bf16) for bf16 in (False, True)]
        del variables
        results["trained"] = compare_dtypes("bf16_main trained", *preds, image, xyz)
        del preds
        torch.cuda.empty_cache()
    return launches, skip_launches


def fps_groups_check(results):
    """F3: FPS at B=160 crops of 224^2 (8 frames x 20 crops), which one
    launch cannot hold: grouped launches (fps_plan's groups); the images on
    both sides of each group boundary held to the fp64 argmax chain, and
    launched together in one call, which gives the same indices."""
    B, N = 160, 224 * 224
    X, first, groups = clustered_unit_vectors(B, N, seed=2)
    plan = fps_plan(B, N, **device_limits(X.device))
    fps_seeds.launches = 0
    seeds, idx = fps_seeds(X, first, SEEDS)
    torch.cuda.synchronize()
    n_launches = fps_seeds.launches
    edge = sorted({b for _, g1 in plan["groups"][:-1] for b in (g1 - 1, g1)})
    sub = torch.tensor(edge, device="cuda")
    r = fps_gate(X[sub], first[sub], seeds[sub], idx[sub], groups)
    alone = fps_seeds(X[sub].contiguous(), first[sub], SEEDS)[1]
    same = torch.equal(alone, idx[sub])
    ms = time_ms(lambda: fps_seeds(X, first, SEEDS), warmup=1, reps=3)
    results["fps_groups_B160_N50176"] = dict(groups=plan["groups"], launches=n_launches,
                                             boundary_images=edge, max_gap=r["max_gap"],
                                             same_as_one_launch=same, ms=ms)
    sync_print(f"ucn_check fps_groups B160_N50176: groups={plan['groups']} launches={n_launches} "
               f"boundary images {edge}: max_gap_vs_fp64={r['max_gap']:.3e} "
               f"(tol={FPS_TOL:.0e}) seeds_bit_exact={r['bit_exact']} first_ok={r['starts']} "
               f"ties_to_lowest={r['tie_ok']} same_indices_as_one_launch={same} kernel_ms={ms:.3f}")
    if not (r["ok"] and same and n_launches == len(plan["groups"]) > 1):
        raise AssertionError("grouped FPS launches disagree with the fp64 chain")
    del X, first, seeds, idx
    torch.cuda.empty_cache()


def seeds_200_check(results):
    """F4: 200 seeds (two seed blocks of the climbing kernel, a 256-thread
    connected-components block) at B=2/N=50,176: FPS per step against fp64,
    the climbing against fp64 (CLIMB_TOL), the components equal to the
    numpy sweep."""
    S, B, N = 200, 2, 224 * 224
    X, first, groups = clustered_unit_vectors(B, N, seed=3)
    seeds, idx, gap = check_fps("seeds200_B2_N50176", X, first, groups, S=S)
    err = check_climb("seeds200_B2_N50176", X, first, seeds, idx, S=S)
    Z = mean_shift_seeds(X, first, KAPPA, S, ITERS)[0]
    within = seed_adjacency(Z, EPSILON)
    cc = connected_components_sweep(within)
    equal = torch.equal(cc.cpu(), connected_components_plain(within).cpu())
    results["seeds200_B2_N50176"] = dict(fps_max_gap=gap, climb_max_abs_err=err,
                                         components_equal=equal,
                                         components=int(cc.max()) + 1)
    sync_print(f"ucn_check seeds200_B2_N50176: connected components equal to the numpy sweep="
               f"{equal} ({int(cc.max()) + 1} components at most)")
    if not equal:
        raise AssertionError("connected components at 200 seeds disagree with the numpy sweep")


# Rows 1-2 at the key counts of the standard-backbone pyramid: the 3-level
# decoder attends res5, res4 and res3 in turn (strides 32, 16, 8) of a
# 480x640 frame and of the 224x224 crops. K = 49 is less than one 64-key
# tile and K % 4 = 1; K = 300 and 196 are not multiples of 8, so their rows
# are copied without 16-byte copies in bf16.
R50_SHAPES = {   # name: (B, h, w, absent)
    "r50_stage1_B1_K300": (1, 15, 20, ()),
    "r50_stage1_B1_K1200": (1, 30, 40, ()),
    "r50_stage1_B1_K4800": (1, 60, 80, ()),
    "r50_crops_B20_K49": (20, 7, 7, (3, 11)),
    "r50_crops_B20_K196": (20, 14, 14, (3, 11)),
    "r50_crops_B20_K784": (20, 28, 28, (3, 11)),
}
R50_LEVELS = ((15, 20), (30, 40), (60, 80))      # stage 1 at 480x640
R50_CROP_LEVELS = ((7, 7), (14, 14), (28, 28))   # 224x224 crops


def r50_check_phase():
    """21. rows 1-2 at R50_SHAPES: the fp32 kernel against its plain version
    in fp64 (TOL) and the bf16 kernel against its twin (BF16_TOL), both
    positional forms, guard queries and absent crops; the tile-skipping
    variant (and force_all) equal to the dense kernel (torch.equal) in both
    dtypes, on the check inputs and on concentrated masks; the launches each
    shape's checks made (each call of the wrapper is one launch), kernel
    (fp32, bf16 in turns), plain and bound ms.
    -> {case: results}."""
    results = {}
    for name, (B, h, w, absent) in R50_SHAPES.items():
        K = h * w
        before = fused_uoms_cross_attention.launches
        sm = torch.cuda.get_device_properties(0).multi_processor_count
        r = results[name] = {"K": K, "tiles": -(-K // TILE_KEYS), "K_mod_8": K % 8,
                             "launch_plan": launch_plan(B, H, K, sm)}
        r["max_abs_err"] = max(check_case(name, B, h, w, absent, form)[2] for form in FORMS)
        r["bf16_max_abs_err"] = max(check_bf16_case(name, B, h, w, absent, form)[2]["max_abs_err"]
                                    for form in FORMS)
        equal, shares = {}, {}
        for conc in (False, True):
            args32, present = (concentrated_inputs(B, h, w, absent) if conc
                               else make_inputs(B, h, w, absent))
            tag = "concentrated" if conc else "check"
            shares[tag] = skipped_share(args32[3], args32[2], present)[0]
            for dt, args in (("fp32", args32), ("bf16", to_bf16(args32))):
                call = lambda **kw: fused_uoms_cross_attention(*args, present=present, **kw)
                dense = call()
                equal[f"{dt}_{tag}"] = (torch.equal(call(tile_skip=True), dense) and torch.equal(
                    call(tile_skip=True, tile_skip_force_all=True), dense))
            del args32, args, present, dense
        r.update(tile_skip_equal=equal, skipped_share=shares,
                 check_launches=fused_uoms_cross_attention.launches - before)
        args, present = make_inputs(B, h, w, absent)
        args16 = to_bf16(args)
        ms = time_in_turns({
            "fp32": lambda: fused_uoms_cross_attention(*args, present=present),
            "bf16": lambda: fused_uoms_cross_attention(*args16, present=present)})
        r["plain_ms"] = time_ms(lambda: fused_uoms_cross_attention_plain(*args, present=present),
                                warmup=1, reps=3)
        tc, fma, nbytes = work(args, present)
        r["ms"], r["bf16_ms"] = ms["fp32"], ms["bf16"]
        r["bound_ms"], r["bound_by"] = tf32x3_bound(tc, fma, nbytes)
        r["bf16_bound_ms"], r["bf16_bound_by"] = bf16_bound(*work(args16, present))
        r.update(gflop=(tc + fma) / 1e9, gbytes=nbytes / 1e9)
        sync_print(f"r50_check {name}: K={K} tiles={r['tiles']} launch_plan={r['launch_plan']} "
                   f"max_abs_err={r['max_abs_err']:.3e} (fp64, tol={TOL:.0e}) "
                   f"bf16_max_abs_err={r['bf16_max_abs_err']:.3e} (twin, tol={BF16_TOL:.0e}) "
                   f"tile_skip_equal={equal} skipped_share={shares} "
                   f"launches_of_the_checks={r['check_launches']} "
                   f"kernel_ms fp32={r['ms']:.4f} bf16={r['bf16_ms']:.4f} "
                   f"plain_ms={r['plain_ms']:.3f} bound_ms fp32={r['bound_ms']:.4f} "
                   f"({r['bound_by']}; {r['gflop']:.3f} GFLOP, {r['gbytes'] * 1e3:.2f} MB) "
                   f"bf16={r['bf16_bound_ms']:.4f} ({r['bf16_bound_by']})")
        if not all(equal.values()):
            raise AssertionError(f"tile skipping differs from the dense kernel at {name}")
        del args, args16, present
        torch.cuda.empty_cache()
    return results


def run_frame(tag, pred, image, xyz, layers):
    """One frame through a predictor with the counts zeroed before:
    asserts `layers` cross-attention launches in each stage, general pos 0,
    >= 1 crop and int32 labels of the frame's size. -> (stage-1 result,
    refined, launches stage 1, stage 2, crops)."""
    zero_counts()
    s1 = pred.stage1(image, xyz)
    torch.cuda.synchronize()
    n1 = fused_uoms_cross_attention.launches
    refined = pred.refine(s1)
    torch.cuda.synchronize()
    n2 = fused_uoms_cross_attention.launches - n1
    crops = int(sum(int(c.present.sum()) for c in s1.crops))
    assert fused_uoms_cross_attention.general_pos_launches == 0, f"{tag}: general pos"
    assert crops >= 1, f"{tag}: stage 1 gave no crop, so stage 2 did not run"
    assert n1 == layers and n2 == layers, f"{tag}: launches {n1} + {n2}, expected {layers} each"
    assert s1.labels.shape == refined.shape == (image.shape[0], *image.shape[1:3])
    assert s1.labels.dtype == refined.dtype == torch.int32
    return s1, refined, n1, n2, crops


# The standard-backbone network on the card against the same weights on the
# CPU (cuDNN against CPU convolutions, the kernel against its plain version),
# on a small input: each output within R50_CPU_TOL of its scale. Both are
# fp32 with TF32 off and the kernel's products in 3xTF32, so they differ by
# rounding; a wrong level, layout or weight shows as O(1). The deviation is
# printed.
R50_CPU_TOL = 1e-3


def small_input_agreement(model, hw=(96, 128)):
    """The fp32 network's pred_logits, mask_embed and mask_features on a
    seeded hw image, on the card and on a CPU copy. Raises beyond
    R50_CPU_TOL. -> {output: max |card - cpu| over the CPU scale}."""
    import copy

    g = torch.Generator().manual_seed(1)
    image = torch.rand(1, *hw, 3, generator=g) * 255
    with torch.inference_mode():
        got = model(image.cuda(), light=True)
        want = copy.deepcopy(model).cpu()(image, light=True)
    dev = {k: ((got[k].cpu() - want[k]).abs().max() / want[k].abs().max().clamp_min(1e-30)).item()
           for k in ("pred_logits", "mask_embed", "mask_features")}
    sync_print(f"r50_main small input {hw}: card vs CPU max deviation of scale "
               + " ".join(f"{k}={v:.2e}" for k, v in dev.items()) + f" (tol {R50_CPU_TOL:.0e})")
    if not all(v <= R50_CPU_TOL for v in dev.values()):
        raise AssertionError("the standard-backbone network on the card disagrees with the CPU")
    return dev


def r50_main_phase(results):
    """22. the standard-backbone two-stage path at full width through
    build_two_stage_predictor: tabletop_pretrained_resnet50 with
    crop_tabletop_resnet50_rgb (ResNet50, MSDeformAttn pixel decoder with 6
    encoder layers, 9-layer 3-level decoder, hidden 256, 8 heads, 100
    queries) at 480x640, B=1, fp32 with TF32 off, on the decisive weights of
    main: 9 + 9 cross-attention launches, crops, outputs, the network against
    its CPU copy on a small input, e2e (median of 3 after a warm-up),
    breakdown, peak memory, the kernel checked again at the crop count stage
    2 ran; the same frame with bf16=True against fp32
    (compare_dtypes); one frame each of tabletop_swin, pushing_resnet50 (with
    depth), uoais_resnet50 (up to 40 crops) and mixture_resnet50 with their
    crop presets, in fp32 and in bf16 (9 + 9 launches, >= 1 crop, e2e).
    -> (fp32 launches, bf16 launches) of the R50 frame."""
    image, xyz = synthetic_rgbd(seed=0)
    pred = decisive_predictor(seed=0, preset="tabletop_pretrained_resnet50")
    s1, refined, n1, n2, crops = run_frame("r50_main", pred, image, None, 9)
    with torch.inference_mode():
        out = pred.model(image, light=True)
    assert all(bool(torch.isfinite(out[k]).all())
               for k in ("pred_logits", "mask_embed", "mask_features")), "r50_main outputs"
    mf_shape = tuple(out["mask_features"].shape)
    assert mf_shape == (1, 120, 160, 256), f"r50_main mask_features {mf_shape}"
    del out
    small = small_input_agreement(pred.model)
    results["small_input_vs_cpu"] = small
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    e2e, runs = median_ms(lambda: pred(image))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with torch.inference_mode():
        parts = {"stage1_backbone": backbone_fn(pred.model, image, None),
                 "stage1_network": lambda: pred.model(image, light=True),
                 "stage1_total": lambda: pred.stage1(image),
                 "refine_total": lambda: pred.refine(s1)}
        split = {k: median_ms(f)[0] for k, f in parts.items()}
    results["fp32"] = dict(launches_stage1=n1, launches_stage2=n2, crops=crops,
                           stage1_instances=int((s1.labels.unique() >= 2).sum()),
                           refined_instances=int((refined.unique() >= 1).sum()),
                           e2e_ms=e2e, runs_ms=runs, peak_gib=peak, breakdown_ms=split)
    sync_print(f"r50_main fp32: launches stage1={n1} stage2={n2} crops={crops} "
               f"stage1_instances={results['fp32']['stage1_instances']} "
               f"refined_instances={results['fp32']['refined_instances']} mask_features "
               f"{mf_shape}; e2e_ms median of 3 = {e2e:.1f} (runs "
               f"{', '.join(f'{t:.1f}' for t in runs)}) peak_memory={peak:.2f} GiB; breakdown "
               "median ms " + " ".join(f"{k}={v:.1f}" for k, v in split.items()))
    for (h, w), name in zip(R50_CROP_LEVELS, ("K49", "K196", "K784")):
        tag = f"r50_stage2_B{crops}_{name}"
        results[tag] = {"max_abs_err": check_case(tag, crops, h, w)[2]}
    launches = n1 + n2
    del s1, refined
    torch.cuda.empty_cache()

    p16 = decisive_predictor(seed=0, preset="tabletop_pretrained_resnet50", bf16=True)
    results["bf16"] = compare_dtypes("r50_main bf16", pred, p16, image, None)
    bf16_launches = results["bf16"]["bf16_launches"]
    del pred, p16
    torch.cuda.empty_cache()

    for preset, frame_xyz in (("tabletop_swin", None), ("pushing_resnet50", xyz),
                              ("uoais_resnet50", None), ("mixture_resnet50", None)):
        for bf16 in (False, True):
            tag = f"{preset}_bf16" if bf16 else preset
            pred = decisive_predictor(seed=0, preset=preset, bf16=bf16)
            _, _, m1, m2, c = run_frame(f"r50_main {tag}", pred, image, frame_xyz, 9)
            b = fused_uoms_cross_attention.bf16_launches
            assert b == (m1 + m2 if bf16 else 0), f"r50_main {tag}: {b} bf16 launches"
            t = median_ms(lambda: pred(image, frame_xyz))[0]
            results[tag] = dict(launches_stage1=m1, launches_stage2=m2, bf16_launches=b,
                                crops=c, e2e_ms=t, depth=frame_xyz is not None,
                                crop_preset=pred.cfg_crop.name)
            sync_print(f"r50_main {tag}: crop preset {pred.cfg_crop.name} launches stage1={m1} "
                       f"stage2={m2} (bf16 {b}) crops={c} depth={frame_xyz is not None} "
                       f"e2e_ms={t:.1f}")
            del pred
            torch.cuda.empty_cache()
    return launches, bf16_launches


# Training (the JAX package's second main path). The JAX train step runs no
# Pallas kernel (use_pallas is off in training: the decoder's unfused path),
# so no kernel is held here; the train step on the card is held to the
# port's own CPU copy, on the same weights, batch and draws.
#
# TRAIN_CPU_TOL: every loss term and the global gradient norm of the
# full-width network on the card within 1e-3 of the CPU copy's, relative.
# Both run fp32 with TF32 off; cuDNN and cuBLAS sum in other orders than the
# CPU kernels, and kappa-30 attention and the LayerNorms amplify that to
# ~1e-5 at the toy widths of the CPU tests; the mask logits' signs and the
# assignment are discrete, so a near-tie may move a term further. A wrong
# layout, weight or draw shows as O(0.1). The deviations are printed.
TRAIN_CPU_TOL = 1e-3
# TWOPASS_TOL: the chunked two-pass attention in fp32 against the dense
# masked attention in fp64 on the same inputs, forward and every gradient,
# each within 1e-4 of its scale (kappa 30 over 40,000 keys; a dropped chunk
# or a wrong guard shows as O(1)).
TWOPASS_TOL = 1e-4
TRAIN_HW, CROP_HW, TRAIN_BATCH, TRAIN_STEPS, TRAIN_WARMUP, BF16_STEPS = (480, 640), 224, 4, 8, 2, 3
R5_METRICS = "checkpoints/msmformer_synthetic_r5_metrics.jsonl"


def scale_dev(got, want):
    """max |got - want| over max |want|, in fp64."""
    got, want = got.double().cpu(), want.double().cpu()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def grad_norm(model):
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads))).item()


def train_cpu_agreement(results):
    """One train step's forward and backward of the full-width
    tabletop_pretrained network at 96x128, B=2, on a batch the port's
    renderer made on the card: loss terms and the global gradient norm on
    the card against a CPU copy (TRAIN_CPU_TOL)."""
    cfg = get_config("tabletop_pretrained")
    tr = Trainer(cfg, device="cuda", seed=0)
    batch = SyntheticDeviceLoader(2, height=96, width=128, max_gt=cfg.loss.max_gt_instances,
                                  seed=0).batch_at(0)
    draws = tr.draws(batch)
    cpu = Trainer(cfg, device="cpu", seed=0, model=copy.deepcopy(tr.model).cpu())
    total, losses = tr.gradients(batch, draws)
    want_total, want = cpu.gradients({k: v.cpu() for k, v in batch.items()}, draws.to("cpu"))
    dev = {k: abs(float(losses[k]) - float(want[k])) / max(abs(float(want[k])), 1e-3)
           for k in want}
    dev["total_loss"] = abs(float(total.detach()) - float(want_total)) / abs(float(want_total))
    norms = grad_norm(tr.model), grad_norm(cpu.model)
    dev["grad_norm"] = abs(norms[0] - norms[1]) / norms[1]
    worst = max(dev, key=dev.get)
    results["cpu_agreement"] = {"total_loss": float(total), "grad_norm": norms[0],
                                "deviation": dev}
    total = total.detach()
    sync_print(f"train_check full width 96x128 B=2: total_loss card {float(total):.6f} cpu "
               f"{float(want_total):.6f}, grad_norm card {norms[0]:.6f} cpu {norms[1]:.6f}; "
               f"worst relative deviation {dev[worst]:.2e} ({worst}; tol {TRAIN_CPU_TOL:.0e}; "
               f"{len(want)} loss terms)")
    if dev[worst] > TRAIN_CPU_TOL:
        raise AssertionError("the train step on the card disagrees with its CPU copy")
    return tr, batch


def twopass_check(results, K=40000):
    """The chunked two-pass attention (B=1, Q=100, E=256, 8 heads, K keys:
    5 chunks of 8,192, the last short; 3 guard rows) in fp32 against the
    dense masked attention in fp64: output and the gradients of query, key,
    value and every projection (TWOPASS_TOL)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    B, Qn, En = 1, 100, 256
    rnd = lambda *s, sc=1.0: torch.randn(*s, generator=g, device="cuda") * sc   # noqa: E731
    leaves = [rnd(B, Qn, En), rnd(B, K, En), rnd(B, K, En), rnd(3 * En, En, sc=En ** -0.5),
              rnd(3 * En, sc=0.1), rnd(En, En, sc=En ** -0.5), rnd(En, sc=0.1)]
    logits = rnd(B, Qn, K)
    logits[0, :3] = -1.0 - logits[0, :3].abs()
    cot = rnd(B, Qn, En)
    x32 = [t.clone().requires_grad_() for t in leaves]
    x64 = [t.double().requires_grad_() for t in leaves]
    out32 = chunked_masked_meanshift_attention_twopass(*x32[:3], *x32[3:], 8, logits >= 0)
    (out32 * cot).sum().backward()
    out64, _ = meanshift_attention(*x64[:3], *x64[3:], 8,
                                   mask_bias=bool_mask_to_bias(logits < 0).double())
    (out64 * cot.double()).sum().backward()
    names = ("out", "d_query", "d_key", "d_value", "d_in_proj_weight", "d_in_proj_bias",
             "d_out_weight", "d_out_bias")
    dev = dict(zip(names, [scale_dev(out32.detach(), out64.detach())]
                   + [scale_dev(a.grad, b.grad) for a, b in zip(x32, x64)]))
    results["twopass_vs_fp64"] = dev
    sync_print(f"train_check twopass K={K} vs dense fp64: "
               + " ".join(f"{k}={v:.2e}" for k, v in dev.items()) + f" (tol {TWOPASS_TOL:.0e})")
    if max(dev.values()) > TWOPASS_TOL:
        raise AssertionError("the chunked training attention disagrees with fp64")


def train_check_phase():
    """23. the train step on the card against its CPU copy, the chunked
    attention against fp64, and the non-finite skip."""
    results = {}
    tr, batch = train_cpu_agreement(results)
    twopass_check(results)
    state = {k: v.clone() for k, v in tr.model.state_dict().items()}
    bad = dict(batch, image=batch["image"].clone())
    bad["image"][0, 0, 0, 0] = float("nan")
    metrics = tr.train_step(bad)
    skipped = float(metrics["skipped_nonfinite"])
    unchanged = all(torch.equal(v, tr.model.state_dict()[k]) for k, v in state.items())
    results["nonfinite"] = {"skipped_nonfinite": skipped, "unchanged": unchanged,
                            "optimizer_state_empty": not tr.optimizer.state}
    sync_print(f"train_check NaN batch: skipped_nonfinite={skipped:.0f}, parameters and "
               f"running statistics unchanged={unchanged}, optimizer state untouched="
               f"{not tr.optimizer.state}")
    if skipped != 1.0 or not unchanged or tr.optimizer.state:
        raise AssertionError("a non-finite step changed the training state")
    return results


def train_steps(tag, cfg, batch, steps, warmup=TRAIN_WARMUP, model=None, gate=True):
    """`steps` train steps on one fixed batch from seed-0 weights (or
    `model`): host-clock ms of each step (synchronized), every loss term,
    peak memory, skips. Gates (with gate): every loss finite, the total
    loss falls from the first step to the last. -> (trainer, summary)."""
    tr = Trainer(cfg, device="cuda", seed=0, model=model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, metrics = [], []
    for _ in range(steps):
        t = time.perf_counter()
        m = tr.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        metrics.append(m)
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    summary = {"step_ms_median": statistics.median(times[warmup:]), "step_ms": times,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "skipped": sum(m["skipped_nonfinite"] for m in metrics),
               "total_loss": [m["total_loss"] for m in metrics], "last": metrics[-1],
               "first": metrics[0], "shape": tuple(batch["image"].shape)}
    finite = all(math.isfinite(v) for m in metrics for v in m.values())
    sync_print(f"train_main {tag}: image {summary['shape']} steps={steps} step_ms median of "
               f"{steps - warmup} after {warmup} warm-ups = {summary['step_ms_median']:.1f} (all "
               f"{', '.join(f'{t:.1f}' for t in times)}) peak_memory={summary['peak_gib']:.2f} "
               f"GiB skipped={summary['skipped']:.0f}; total_loss "
               + " ".join(f"{v:.4f}" for v in summary["total_loss"]))
    sync_print(f"train_main {tag} last step: " + " ".join(
        f"{k}={v:.4f}" for k, v in sorted(metrics[-1].items())))
    if gate and not (finite and summary["skipped"] == 0
                     and summary["total_loss"][-1] < summary["total_loss"][0]):
        raise AssertionError(f"train_main {tag}: a loss is not finite, a step was skipped or "
                             "the loss on the fixed batch did not fall")
    return tr, summary


def serve_checkpoints(results, whole, crop):
    """Save both trained networks with checkpoint_io, restore them into fresh
    trainers (equal state), and serve one 480x640 frame through
    build_two_stage_predictor(checkpoint=..., checkpoint_crop=...): 6
    cross-attention launches in stage 1 and 6 in stage 2. Eight steps from
    random weights leave every mask of this frame empty (measured: no
    instance, even made decisive as main's), so when stage 1 gives no crop,
    the served crop network refines the crops that main's decisive stage 1
    cuts from the same frame."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        paths = []
        for tr in (whole, crop):
            path = checkpoint_io.save(os.path.join(d, f"{tr.cfg.name}.pth"), tr)
            fresh = Trainer(tr.cfg, device="cuda", seed=1)
            assert checkpoint_io.restore(path, fresh) == tr.step
            assert all(torch.equal(v, fresh.model.state_dict()[k])
                       for k, v in tr.model.state_dict().items()), "restore changed the weights"
            paths.append(path)
        pred = build_two_stage_predictor(checkpoint=paths[0], checkpoint_crop=paths[1])
    for model, tr in ((pred.model, whole), (pred.model_crop, crop)):
        assert all(torch.equal(v, model.state_dict()[k])
                   for k, v in tr.model.state_dict().items()), "the served weights differ"
    image, xyz = synthetic_rgbd(seed=0)
    zero_counts()
    s1 = pred.stage1(image, xyz)
    torch.cuda.synchronize()
    n1 = fused_uoms_cross_attention.launches
    crops = int(sum(int(c.present.sum()) for c in s1.crops))
    source = "trained stage 1"
    if not crops:
        s1 = decisive_predictor(seed=0).stage1(image, xyz)
        crops = int(sum(int(c.present.sum()) for c in s1.crops))
        source = "main's decisive stage 1"
    torch.cuda.synchronize()
    before = fused_uoms_cross_attention.launches
    refined = pred.refine(s1)
    torch.cuda.synchronize()
    n2 = fused_uoms_cross_attention.launches - before
    serve = {"launches_stage1": n1, "launches_stage2": n2, "crops": crops, "crops_from": source,
             "refined_instances": int((refined.unique() >= 1).sum())}
    results["serve_after_train"] = serve
    sync_print(f"train_main serve after train: {serve}")
    assert n1 == 6 and n2 == 6 and crops >= 1, f"serve-after-train launches {n1} + {n2}"
    assert refined.shape == (1, 480, 640) and refined.dtype == torch.int32
    return serve


def finetune_from(results, weights):
    """With --weights: 8 steps from those weights (the embedding loss on, as
    r5 was trained) on the loader's stream, the losses beside the last
    records of the release's metrics.jsonl. No gate."""
    cfg = get_config("tabletop_pretrained")
    cfg.loss.use_embedding_loss = True
    model = new_model(cfg, 0, "cpu")
    model.load_state_dict(from_jax_variables(load_npz_variables(weights)))
    loader = SyntheticDeviceLoader(TRAIN_BATCH, max_gt=cfg.loss.max_gt_instances, seed=0)
    tr = Trainer(cfg, device="cuda", seed=0, model=model.cuda())
    losses = []
    for step in range(TRAIN_STEPS):
        m = tr.train_step(loader.batch_at(step))
        losses.append({k: float(v) for k, v in m.items()})
    results["finetune"] = losses
    sync_print("train_main fine-tune from --weights, total_loss per step: "
               + " ".join(f"{m['total_loss']:.4f}" for m in losses))
    beside = os.path.join(os.path.dirname(weights), os.path.basename(R5_METRICS))
    metrics = next((m for m in (R5_METRICS, beside) if os.path.exists(m)), None)
    if metrics:
        with open(metrics) as f:
            last = [json.loads(line) for line in f if '"train"' in line][-3:]
        sync_print("train_main the release's last logged steps (JAX package, TPU run): "
                   + "; ".join(f"iter {r['iter']} total_loss {r['total_loss']:.4f}"
                               for r in last))
    else:
        sync_print(f"train_main: no {os.path.basename(R5_METRICS)} in {R5_METRICS} or "
                   "beside the weights")


def train_main_phase(results, weights=None):
    """24. training at full width: the whole-image network at 480x640 and the
    crop network on 224^2 SYN_CROP crops, B=4, 8 steps each on a fixed
    batch from SyntheticDeviceLoader; 3 bf16 steps against fp32's first;
    checkpoints served after training."""
    cfg = get_config("tabletop_pretrained")
    G = cfg.loss.max_gt_instances
    batch = SyntheticDeviceLoader(TRAIN_BATCH, *TRAIN_HW, max_gt=G, seed=0).batch_at(0)
    whole, results["whole"] = train_steps("whole-image fp32", cfg, batch, TRAIN_STEPS)
    crop_cfg = get_config("crop_tabletop_pretrained")
    crop_batch = SyntheticDeviceLoader(TRAIN_BATCH, max_gt=G, seed=0, syn_crop=True,
                                       crop_size=CROP_HW).batch_at(0)
    crop, results["crop"] = train_steps("crop fp32", crop_cfg, crop_batch, TRAIN_STEPS)
    cfg16 = copy.deepcopy(cfg)
    cfg16.dtype = "bfloat16"
    tr16, results["whole_bf16"] = train_steps("whole-image bf16", cfg16, batch, BF16_STEPS,
                                              warmup=1, gate=False)
    first32 = results["whole"]["first"]["total_loss"]
    first16 = results["whole_bf16"]["first"]["total_loss"]
    rel = abs(first16 - first32) / abs(first32)
    results["whole_bf16"]["step0_vs_fp32"] = rel
    sync_print(f"train_main bf16 step 0 total_loss {first16:.4f} vs fp32 {first32:.4f}: "
               f"relative {rel:.2e} (tol 5e-2)")
    finite = all(math.isfinite(v) for v in results["whole_bf16"]["total_loss"])
    if not finite or rel > 0.05 or results["whole_bf16"]["skipped"]:
        raise AssertionError("bf16 training is not finite or its first loss is off fp32's")
    del tr16
    torch.cuda.empty_cache()
    serve_checkpoints(results, whole, crop)
    if weights:
        del whole, crop
        torch.cuda.empty_cache()
        finetune_from(results, weights)
    return results


# Dataset evaluation (cli/test_net.py). The card machine has neither cv2 nor
# PIL: the port decodes PNG and PCD itself (utils/image_io.py, data/pcd.py)
# and scores on the host with its native library (native/uoms_native.cpp,
# built by g++). eval_check holds the native decoders and counts to their
# numpy twins; eval_main writes OCID- and OSD-layout
# trees of scenes the port renders on the card, reads them back through the
# readers and evaluates them through cli.test_net; train_eval trains with
# --eval-period. The host library is no GPU kernel: it has no kernels entry.
EVAL_HW = (480, 640)
OCID_FRAMES, OSD_FRAMES, EVAL_BATCH = 16, 8, 4
EVAL_DEVICE = "cuda"
CARD = "card not read yet"          # the nvidia-smi line, set by main


def png_roundtrip_check():
    """Every colour type and bit depth through the port's encoder with each
    row filter forced, decoded by both backends: the samples must come back
    as written. -> number of files."""
    from unseenobjectswithmeanshift_torch.utils.image_io import decode_png, encode_png

    rng = np.random.RandomState(0)
    files = []
    for depth, dt, top in ((8, np.uint8, 255), (16, np.uint16, 65535)):
        for c in (1, 2, 3, 4):                          # colour types 0, 4, 2, 6
            s = (rng.rand(48, 64, c) * top).astype(dt)
            files += [(s, None, f) for f in range(5)]
    idx = rng.randint(0, 200, (48, 64)).astype(np.uint8)
    pal = (rng.rand(200, 3) * 255).astype(np.uint8)
    files += [(idx[..., None], pal, f) for f in range(5)]  # colour type 3
    for s, palette, f in files:
        data = encode_png(s if palette is None else s[..., 0], palette=palette, filters=f)
        for backend in ("native", "numpy"):
            png = decode_png(data, backend)
            if not np.array_equal(png.samples, s) or png.samples.dtype != s.dtype:
                raise AssertionError(f"PNG round trip differs: {s.dtype} {s.shape[-1]} "
                                     f"channels, filter {f}, {backend}")
    return len(files)


def pcd_check(d):
    """ascii, binary and binary_compressed clouds at 480x640 with NaN holes:
    read_pcd_xyz in both backends equal to what was written (NaN -> 0), and
    the native LZF equal to the Python LZF and to the written field bytes.
    -> {kind: {backend: ms}}."""
    from unseenobjectswithmeanshift_torch import native
    from unseenobjectswithmeanshift_torch.data import pcd

    rng = np.random.RandomState(1)
    h, w = EVAL_HW
    xyz = rng.randn(h, w, 3).astype(np.float32)
    xyz[rng.rand(h, w) < 0.05] = np.nan
    want = np.nan_to_num(xyz.reshape(-1, 3))
    out = {}
    for kind in ("ascii", "binary", "binary_compressed"):
        path = os.path.join(d, f"{kind}.pcd")
        pcd.write_pcd_xyz(path, xyz, kind=kind)
        out[kind] = {}
        for backend in ("native", "numpy"):
            t0 = time.perf_counter()
            got = pcd.read_pcd_xyz(path, backend)
            out[kind][backend] = (time.perf_counter() - t0) * 1e3
            if got.dtype != np.float32 or not np.array_equal(got, want):
                raise AssertionError(f"read_pcd_xyz({kind}, {backend}) differs from the cloud")
    raw = b"".join([np.ascontiguousarray(xyz.reshape(-1, 3)[:, i]).tobytes() for i in range(3)]
                   + [np.zeros(h * w, np.uint32).tobytes()])
    comp = pcd.lzf_literal(raw)
    if not native.lzf_decompress(comp, len(raw)) == pcd._lzf_decompress(comp, len(raw)) == raw:
        raise AssertionError("native LZF, Python LZF and the written bytes differ")
    return out


def eval_label_pairs(n=16, seed=0):
    """n seeded 480x640 (prediction, ground truth) label pairs of discs and
    boxes: pair 0 has an empty prediction, pair 1 an empty ground truth, pair
    2 tied overlaps (each object split in two equal halves by two predicted
    labels); the rest 3-20 objects a side, prediction ids up to 60."""
    rng = np.random.RandomState(seed)
    h, w = EVAL_HW
    ys, xs = np.mgrid[:h, :w]

    def scene(k, top):
        lab = np.zeros((h, w), np.int32)
        for _ in range(k):
            cy, cx, r = rng.randint(0, h), rng.randint(0, w), rng.randint(8, 80)
            shape = ((ys - cy) ** 2 + (xs - cx) ** 2 <= r * r) if rng.rand() < 0.5 else (
                (abs(ys - cy) <= r) & (abs(xs - cx) <= rng.randint(8, 80)))
            lab[shape] = rng.randint(1, top + 1)
        return lab

    pairs = [(np.zeros((h, w), np.int32), scene(8, 8)), (scene(8, 8), np.zeros((h, w), np.int32))]
    gt = np.zeros((h, w), np.int32)
    gt[100:200, 100:300], gt[250:350, 300:500] = 1, 2
    tied = gt * 0
    tied[100:200, 100:200], tied[100:200, 200:300] = 3, 4
    tied[250:350, 300:400], tied[250:350, 400:500] = 5, 6
    pairs.append((tied, gt))
    while len(pairs) < n:
        pairs.append((scene(rng.randint(3, 21), 60), scene(rng.randint(3, 21), 20)))
    return pairs


def metrics_equal(a, b):
    """Two metric dicts equal value for value, NaN equal to NaN (a label
    filling the image has no boundary: the reference divides 0 by 0)."""
    return a.keys() == b.keys() and all(
        a[k] == b[k] or (a[k] != a[k] and b[k] != b[k]) for k in a)


@contextlib.contextmanager
def without_cv2_or_pil():
    """Inside the block `import cv2` and `import PIL` raise ImportError,
    whether or not this machine has them installed: what runs there needs
    neither. Refuses to start if either is imported already."""
    loaded = [m for m in ("cv2", "PIL") if sys.modules.get(m) is not None]
    if loaded:
        raise AssertionError(f"{loaded} imported before the evaluation phases")
    saved = {m: sys.modules.pop(m, None) for m in ("cv2", "PIL")}
    sys.modules.update({m: None for m in saved})
    try:
        yield
    finally:
        for m in saved:
            del sys.modules[m]


def eval_check_phase():
    """25. the readers' decoders and the scoring backends, with cv2 and PIL
    unimportable."""
    import importlib.util
    import tempfile

    from unseenobjectswithmeanshift_torch import native
    from unseenobjectswithmeanshift_torch.utils.evaluation import multilabel_metrics

    installed = {m: importlib.util.find_spec(m) is not None for m in ("cv2", "PIL")}
    sync_print(f"eval_check: installed on this machine: {installed}; the evaluation phases "
               "run with both made unimportable")
    t0 = time.perf_counter()
    lib = native.build()
    res = {"native_build_s": native.build_seconds, "native_library": os.path.basename(lib)}
    sync_print(f"eval_check: native host library {os.path.basename(lib)} built by g++ in "
               f"{native.build_seconds if native.build_seconds is not None else 0.0:.2f} s "
               f"(None: reused) ({time.perf_counter() - t0:.2f} s with the check)")
    res["png_files"] = png_roundtrip_check()
    sync_print(f"eval_check: PNG round trip of {res['png_files']} files (colour types 0, 2, "
               "3, 4, 6; 8 and 16 bits; filters 0-4 forced) equal in both backends")
    with tempfile.TemporaryDirectory() as d:
        res["pcd_read_ms"] = pcd_check(d)
    sync_print(f"eval_check: PCD ascii / binary / binary_compressed at {EVAL_HW[0]}x{EVAL_HW[1]} "
               f"with NaN equal "
               f"to the cloud in both backends; read ms {res['pcd_read_ms']}")
    pairs = eval_label_pairs()
    ms = {"native": [], "numpy": []}
    for i, (pred, gt) in enumerate(pairs):
        got = {}
        for backend in ("native", "numpy"):
            t = time.perf_counter()
            got[backend] = multilabel_metrics(pred, gt, backend=backend)
            ms[backend].append((time.perf_counter() - t) * 1e3)
        if not metrics_equal(got["native"], got["numpy"]):
            raise AssertionError(f"label pair {i}: native metrics {got['native']} differ from "
                                 f"numpy {got['numpy']}")
    assert pairs[0][0].max() == 0 and pairs[1][1].max() == 0
    res["metric_ms_per_image"] = {b: statistics.median(v) for b, v in ms.items()}
    res["metric_ms_per_image_max"] = {b: max(v) for b, v in ms.items()}
    sync_print(f"eval_check: multilabel_metrics native == numpy on {len(pairs)} "
               f"{EVAL_HW[0]}x{EVAL_HW[1]} pairs "
               f"(empty prediction, empty ground truth, tied overlaps); ms an image, median "
               f"(max): native {res['metric_ms_per_image']['native']:.2f} "
               f"({res['metric_ms_per_image_max']['native']:.2f}), numpy "
               f"{res['metric_ms_per_image']['numpy']:.2f} "
               f"({res['metric_ms_per_image_max']['numpy']:.2f}) [{CARD}; host CPU]")
    return res


def render_eval_frames(n, seed=0):
    """n OCID-style scenes rendered on the card by the port's renderer
    (data/synthetic_device.py, scene_style "ocid", test split) with the depth
    dropout of its augmentation: (bgr uint8 [n, H, W, 3], label [n, H, W]
    int32 objects 1.. and 0 elsewhere, table [n, H, W] bool: the plane's
    pixels, xyz float32 [n, H, W, 3] with NaN where the depth is missing),
    host numpy."""
    from unseenobjectswithmeanshift_torch.data.synthetic_device import (
        augment_depth, render_scene_batch,
    )

    h, w = EVAL_HW
    loader = SyntheticDeviceLoader(n, h, w, image_set="test", seed=seed, scene_style="ocid",
                                   device=EVAL_DEVICE)
    i = loader.intr
    fx, fy, px, py = (float(i[k]) for k in ("fx", "fy", "x_offset", "y_offset"))
    rgb, depth, label = render_scene_batch(loader.params_for(range(n)), h, w, fx, fy, px, py)
    table = (label == 0) & (depth > 0)
    depth = augment_depth(depth, torch.Generator(device=EVAL_DEVICE).manual_seed(seed))
    rows = torch.arange(h, dtype=torch.float32, device=EVAL_DEVICE)[:, None]
    cols = torch.arange(w, dtype=torch.float32, device=EVAL_DEVICE)[None, :]
    xyz = torch.stack([(cols - px) * depth / fx, (rows - py) * depth / fy, depth], -1)
    xyz = torch.where((depth > 0)[..., None], xyz, float("nan"))
    bgr = (rgb.flip(-1) * 255).round().clamp(0, 255).to(torch.uint8)
    return (bgr.cpu().numpy(), label.cpu().numpy().astype(np.int32), table.cpu().numpy(),
            xyz.cpu().numpy())


def write_eval_trees(d, seed=0):
    """An OCID-layout tree of OCID_FRAMES frames (half in a 'table' sequence
    with floor id 2, half in a floor sequence; rgb/*.png, paletted
    label/*.png with table id 1, pcd/*.pcd binary_compressed) and an
    OSD-layout tree of OSD_FRAMES (image_color/, paletted annotation/,
    pcd/ binary), every PNG with the row filters cycling 0-4. -> (ocid
    root, osd root, {file_name: (bgr, expected label, xyz)})."""
    from unseenobjectswithmeanshift_torch.data.datasets import remap_labels
    from unseenobjectswithmeanshift_torch.data.pcd import write_pcd_xyz
    from unseenobjectswithmeanshift_torch.utils.image_io import write_png

    bgr, label, table, xyz = render_eval_frames(OCID_FRAMES + OSD_FRAMES, seed)
    filters = [r % 5 for r in range(EVAL_HW[0])]
    palette = (np.arange(256 * 3) * 37 % 256).astype(np.uint8)
    ocid, osd = os.path.join(d, "OCID"), os.path.join(d, "OSD")
    written = {}
    for k in range(OCID_FRAMES + OSD_FRAMES):
        if k < OCID_FRAMES:
            on_table = k < OCID_FRAMES // 2
            seq = os.path.join(ocid, "ARID20", "table", "top", "seq01") if on_table else \
                os.path.join(ocid, "ARID10", "floor", "bottom", "seq02")
            dirs = {s: os.path.join(seq, s) for s in ("rgb", "label", "pcd")}
            first = 3 if on_table else 2              # table 1 (and floor 2) below the objects
            png = np.where(label[k] > 0, label[k] + first - 1,
                           np.where(table[k], 1, 2 if on_table else 0))
            name = f"result_2018-08-20-10-{k:02d}"
            kind = "binary_compressed"
        else:
            dirs = {"rgb": os.path.join(osd, "image_color"),
                    "label": os.path.join(osd, "annotation"), "pcd": os.path.join(osd, "pcd")}
            png = label[k]
            name = f"learn{k - OCID_FRAMES}"
            kind = "binary"
        for p in dirs.values():
            os.makedirs(p, exist_ok=True)
        path = os.path.join(dirs["rgb"], name + ".png")
        write_png(path, bgr[k][..., ::-1], filters=filters)          # RGB in the file
        write_png(os.path.join(dirs["label"], name + ".png"), png.astype(np.uint8),
                  palette=palette, filters=filters)
        write_pcd_xyz(os.path.join(dirs["pcd"], name + ".pcd"), xyz[k], kind=kind)
        written[path] = (bgr[k], remap_labels(label[k]), xyz[k])
    return ocid, osd, written


def check_reads(dataset, written):
    """Every sample the reader returns equals what was written: the image
    normalized from the written BGR, the cloud (NaN -> 0), the labels of
    the rendered objects after the reader's table / floor removal."""
    from unseenobjectswithmeanshift_torch.data.datasets import normalize_bgr

    for i in range(len(dataset)):
        s = dataset[i]
        bgr, label, xyz = written[s["file_name"]]
        if not (np.array_equal(s["image"], normalize_bgr(bgr))
                and np.array_equal(s["xyz"], np.nan_to_num(xyz))
                and np.array_equal(s["label"], label)):
            raise AssertionError(f"{s['file_name']}: the reader's sample differs from the frame")
    return len(dataset)


class StageSpy:
    """Wraps a predictor's stage1 and refine (instance attributes, which
    stream and __call__ look up) and records, per call, the kernel launches
    it made (host-side counts: no sync is added) and the crops present
    (refine)."""

    def __init__(self, pred):
        self.pred, self.calls = pred, []

    def __enter__(self):
        for name in ("stage1", "refine"):
            orig = getattr(self.pred, name)

            def wrapped(*a, _orig=orig, _name=name, **kw):
                before = kernel_counts()
                bf = fused_uoms_cross_attention.bf16_launches
                if _name == "refine":
                    crops = int(sum(int(c.present.sum()) for c in a[0].crops))
                out = _orig(*a, **kw)
                delta = {k: v - before[k] for k, v in kernel_counts().items()}
                delta["bf16"] = fused_uoms_cross_attention.bf16_launches - bf
                self.calls.append((_name, delta, crops if _name == "refine" else None))
                return out
            setattr(self.pred, name, wrapped)
        return self

    def __exit__(self, *exc):
        del self.pred.stage1, self.pred.refine

    def gate(self, tag, stage1, stage2):
        """stage1 / stage2: {counter: launches a call}; stage 2 launches only
        where crops are present. -> (batches, batches with crops)."""
        s1 = [d for n, d, _ in self.calls if n == "stage1"]
        s2 = [(d, c) for n, d, c in self.calls if n == "refine"]
        for d in s1:
            for k, v in stage1.items():
                assert d[k] == v, f"{tag}: stage 1 made {d[k]} {k} launches, expected {v}"
        for d, c in s2:
            for k, v in stage2.items():
                assert d[k] == (v if c else 0), (
                    f"{tag}: stage 2 with {c} crops made {d[k]} {k} launches, expected "
                    f"{v if c else 0}")
        with_crops = sum(1 for _, c in s2 if c)
        assert len(s1) == len(s2) and with_crops >= 1, f"{tag}: no batch with crops"
        return len(s1), with_crops


def labels_equal_pred(tag, pred, dataset, result, limit, **kw):
    """The labels evaluate scored equal pred(image, xyz) on each batch it
    ran (the short last batch padded as evaluate pads it), torch.equal."""
    from unseenobjectswithmeanshift_torch.data.loader import pad_hw

    n = limit or len(dataset)
    for start in range(0, n, EVAL_BATCH):
        samples = [dataset[i] for i in range(start, min(start + EVAL_BATCH, n))]
        count = len(samples)
        samples += [samples[-1]] * (EVAL_BATCH - count)
        img = torch.from_numpy(np.stack([pad_hw(s["image"]) for s in samples])).to(EVAL_DEVICE)
        xyz = torch.from_numpy(np.stack([pad_hw(s["xyz"]) for s in samples])).to(EVAL_DEVICE)
        labels, refined = pred(img, xyz, **kw)
        for j in range(count):
            for got, want in ((result["labels"], labels), (result["refined"], refined)):
                if not torch.equal(torch.from_numpy(got[start + j]).to(want.device), want[j]):
                    raise AssertionError(f"{tag}: image {start + j}'s scored labels differ "
                                         "from the predictor's on its batch")


def eval_run(tag, pred, dataset, stage1, stage2, limit=0, osd=False, thr=None):
    """evaluate() on the card with the launches counted per stage and gated
    and the scored labels held to the predictor's; then two timed passes,
    with and without the host metrics. -> result line."""
    from unseenobjectswithmeanshift_torch.cli.test_net import evaluate
    from unseenobjectswithmeanshift_torch.utils.evaluation import (
        aggregate_metrics, format_metrics,
    )

    run = lambda **kw: evaluate(pred, dataset, batch=EVAL_BATCH, osd=osd, ucn_threshold=thr,
                                limit=limit, log=lambda s: None, **kw)
    zero_counts()
    with StageSpy(pred) as spy:
        result = run()
    launches = kernel_counts()
    launches["bf16"] = fused_uoms_cross_attention.bf16_launches
    _, with_crops = spy.gate(tag, stage1, stage2)
    kw = {"depth_threshold": thr} if thr is not None else {"osd": osd}
    labels_equal_pred(tag, pred, dataset, result, limit, **kw)
    t = run(keep_labels=False)["timing"]
    card = run(score=False, keep_labels=False)["timing"]
    line = {"images": t["images"], "batches": result["batches"], "batches_with_crops": with_crops,
            "launches": launches, "img_per_s": t["img_per_s"],
            "img_per_s_without_host_metrics": card["img_per_s"],
            "host_metric_ms_per_image": t["metric_ms_per_image"],
            "read_ms_per_image": t["read_ms_per_image"], "read_wait_s": t["read_wait_s"],
            "metric_wait_s": t["metric_wait_s"],
            "metrics": aggregate_metrics(result["metrics"]),
            "metrics_refined": aggregate_metrics(result["metrics_refined"])}
    sync_print(f"eval_main {tag}: {t['images']} images in batches {result['batches']} "
               f"({with_crops} with crops), launches {launches}; {t['img_per_s']:.2f} img/s "
               f"with host metrics, {card['img_per_s']:.2f} without; host metrics "
               f"{t['metric_ms_per_image']:.1f} ms an image (native, on the scoring thread), "
               f"read {t['read_ms_per_image']:.1f} ms an image on the reader thread (without "
               f"metrics {card['read_ms_per_image']:.1f}), the card's thread waited "
               f"{t['read_wait_s']:.3f} s for reads and {t['metric_wait_s']:.3f} s for the "
               f"scoring after the last batch [{CARD}]")
    print(format_metrics(line["metrics"]))
    print("=" * 20 + " Refined " + "=" * 27)
    print(format_metrics(line["metrics_refined"]), flush=True)
    return line


def eval_main_phase(results, weights=None):
    """26. OCID / OSD trees written from scenes rendered on the card, read
    back through the port's readers and evaluated through cli.test_net:
    MSMFormer fp32 and bf16, UCN, then test_net.main through its argv."""
    import tempfile

    from unseenobjectswithmeanshift_torch.cli import test_net
    from unseenobjectswithmeanshift_torch.data.datasets import get_dataset

    d = tempfile.mkdtemp(prefix="uoms_eval_")
    while "rgb" in d or "table" in d:      # the OCID reader replaces / tests these words
        os.rmdir(d)
        d = tempfile.mkdtemp(prefix="uoms_eval_")
    try:
        t0 = time.perf_counter()
        ocid_root, osd_root, written = write_eval_trees(d)
        ocid, osd = get_dataset("ocid_object", ocid_root), get_dataset("osd_object", osd_root)
        results["written_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        n = check_reads(ocid, written) + check_reads(osd, written)
        results["read_back_s"] = time.perf_counter() - t0
        assert len(ocid) == OCID_FRAMES and len(osd) == OSD_FRAMES
        sync_print(f"eval_main: {OCID_FRAMES} OCID + {OSD_FRAMES} OSD frames rendered and "
                   f"written in {results['written_s']:.1f} s; all {n} samples read back equal "
                   f"to the frames in {results['read_back_s']:.1f} s")
        xattn = {"fused_uoms_cross_attention": 6}
        pred = decisive_predictor(seed=0, device=EVAL_DEVICE)
        results["msmformer_ocid"] = eval_run("msmformer fp32 OCID", pred, ocid, xattn, xattn)
        results["msmformer_osd"] = eval_run("msmformer fp32 OSD (limit 7)", pred, osd, xattn,
                                            xattn, limit=OSD_FRAMES - 1, osd=True)
        del pred
        pred16 = decisive_predictor(seed=0, bf16=True, device=EVAL_DEVICE)
        x16 = {"fused_uoms_cross_attention": 6, "bf16": 6}
        results["msmformer_bf16_ocid"] = eval_run("msmformer bf16 OCID", pred16, ocid, x16, x16)
        del pred16
        torch.cuda.empty_cache()
        s = ocid[0]
        image = torch.from_numpy(s["image"][None]).to(EVAL_DEVICE)
        xyz = torch.from_numpy(s["xyz"][None]).to(EVAL_DEVICE)
        ucn = decisive_ucn_predictor(image, xyz, seed=0, device=EVAL_DEVICE)
        ms = {"fps_seeds": 1, "connected_components": 1}
        results["ucn_ocid"] = eval_run("ucn OCID (limit 14)", ucn, ocid, ms, ms,
                                       limit=OCID_FRAMES - 2,
                                       thr=ucn.cfg.test.depth_filter_threshold_ocid)
        del ucn
        torch.cuda.empty_cache()
        for tag, argv in (("random weights", []),
                          ("r5, paired with itself", ["--checkpoint", weights,
                                                      "--checkpoint-crop", weights])):
            if argv and not weights:
                continue
            t0 = time.perf_counter()
            sync_print(f"eval_main test_net.main ({tag}) on the OCID tree [{CARD}]:")
            r = test_net.main(["--dataset", "ocid_object", "--root", ocid_root,
                               "--device", EVAL_DEVICE] + argv)
            results[f"test_net_main_{'r5' if argv else 'random'}"] = {
                "img_per_s": r["timing"]["img_per_s"], "seconds": time.perf_counter() - t0}
    finally:
        import shutil

        shutil.rmtree(d, ignore_errors=True)
    return results


# ---- 28-30: training on files (a TOD tree written from scenes rendered on
# the card: JPEG colour through this baseline encoder, PNG depth and labels)

JPEG_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
    51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
JPEG_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
    92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
JPEG_CHROMA_Q = np.full(64, 99)
JPEG_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]


def _huffman_lengths(counts):
    """Code lengths (at most 16 bits, no all-ones code) for symbol counts
    {symbol: count}: Huffman's merge, then JPEG Annex K.3's length limit."""
    heap = [(c, i, [s]) for i, (s, c) in enumerate(sorted(counts.items()))]
    heap.append((0, -1, [None]))               # the reserved symbol: no code is all ones
    heapq.heapify(heap)
    size = {s: 0 for s in counts}
    size[None] = 0
    tick = len(heap)
    while len(heap) > 1:
        c1, _, a = heapq.heappop(heap)
        c2, _, b = heapq.heappop(heap)
        for s in a + b:
            size[s] += 1
        heapq.heappush(heap, (c1 + c2, tick, a + b))
        tick += 1
    bits = np.zeros(33, np.int64)
    for s, l in size.items():
        bits[l] += 1
    for i in range(32, 16, -1):                # Annex K.3 adjust_bits
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1                               # drop the reserved symbol's code
    order = sorted(counts, key=lambda s: (size[s], s))   # shortest codes first
    lengths, k = {}, 0
    for l in range(1, 17):
        for _ in range(bits[l]):
            lengths[order[k]] = l
            k += 1
    return lengths


def _huffman_table(counts):
    """(DHT counts [16], values, {symbol: (code, length)})."""
    lengths = _huffman_lengths(counts)
    values = sorted(lengths, key=lambda s: (lengths[s], s))
    codes, code, prev = {}, 0, 0
    for s in values:
        code <<= lengths[s] - prev
        prev = lengths[s]
        codes[s] = (code, lengths[s])
        code += 1
    hist = [sum(1 for s in values if lengths[s] == l) for l in range(1, 17)]
    return hist, values, codes


def _dct_matrix():
    k, n = np.arange(8)[:, None], np.arange(8)[None, :]
    c = np.cos((2 * n + 1) * k * np.pi / 16) * np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    return c


def _category(v):
    """(size, extra bits) of a DC difference or AC coefficient."""
    a = abs(int(v))
    s = a.bit_length()
    return s, (int(v) if v >= 0 else int(v) + (1 << s) - 1)


def encode_jpeg(bgr, quality=90, subsample=True, restart=0) -> bytes:
    """A baseline JFIF JPEG of bgr uint8 [H, W, 3]: YCbCr (JFIF), 4:2:0 with
    subsample else 4:4:4, numpy DCT, the standard quantization tables scaled
    to quality as libjpeg scales them, Huffman tables built from the file's
    symbol counts (Annex K.2-K.3), restart markers every ``restart`` MCUs."""
    h, w = bgr.shape[:2]
    b, g, r = (bgr[..., i].astype(np.float64) for i in range(3))
    ycc = [0.299 * r + 0.587 * g + 0.114 * b,
           -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
           0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    f = 2 if subsample else 1
    mh, mw = -(-h // (8 * f)) * 8 * f, -(-w // (8 * f)) * 8 * f
    planes = []
    for i, p in enumerate(ycc):
        p = np.pad(p, ((0, mh - h), (0, mw - w)), mode="edge")
        if i and f == 2:
            p = p.reshape(mh // 2, 2, mw // 2, 2).mean((1, 3))
        planes.append(np.clip(np.round(p), 0, 255) - 128)
    scale = 5000 / quality if quality < 50 else 200 - 2 * quality
    qts = [np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)
           for base in (JPEG_LUMA_Q, JPEG_CHROMA_Q)]          # in zigzag order
    c = _dct_matrix()
    coefs = []                                  # per component [by, bx, 64] zigzag
    for i, p in enumerate(planes):
        ph, pw = p.shape
        blocks = p.reshape(ph // 8, 8, pw // 8, 8).transpose(0, 2, 1, 3)
        dct = np.einsum("ij,abjk,lk->abil", c, blocks, c).reshape(ph // 8, pw // 8, 64)
        coefs.append(np.round(dct[..., JPEG_ZIGZAG] / qts[min(i, 1)]).astype(np.int64))
    mcux, mcuy = mw // (8 * f), mh // (8 * f)
    layout = [(0, f, f), (1, 1, 1), (2, 1, 1)]          # component, h, v
    units = []                                          # (component, block) in scan order
    for m in range(mcux * mcuy):
        my, mx = divmod(m, mcux)
        for comp, hh, vv in layout:
            for v in range(vv):
                for u in range(hh):
                    units.append((m, comp, coefs[comp][my * vv + v, mx * hh + u]))
    # symbols: (table, symbol, extra bits, extra length), restarts marked
    syms, pred, counts, last_m = [], [0, 0, 0], [{}, {}, {}, {}], 0
    for m, comp, blk in units:
        if restart and m != last_m and m % restart == 0:
            syms.append(("rst", m // restart - 1))
            pred = [0, 0, 0]
        last_m = m
        t = min(comp, 1)
        diff = int(blk[0]) - pred[comp]
        pred[comp] = int(blk[0])
        s, e = _category(diff)
        syms.append((2 * t, s, e, s))
        run = 0
        nz = np.nonzero(blk[1:])[0]
        last = nz[-1] + 1 if nz.size else 0
        for k in range(1, last + 1):
            v = int(blk[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                syms.append((2 * t + 1, 0xF0, 0, 0))
                run -= 16
            s, e = _category(v)
            syms.append((2 * t + 1, (run << 4) | s, e, s))
            run = 0
        if last < 63:
            syms.append((2 * t + 1, 0x00, 0, 0))
    for sym in syms:
        if sym[0] != "rst":
            counts[sym[0]][sym[1]] = counts[sym[0]].get(sym[1], 0) + 1
    tables = [_huffman_table(cn) if cn else ([1] + [0] * 15, [0], {0: (0, 1)}) for cn in counts]
    out, acc, nacc = bytearray(), 0, 0

    def flush_bits():
        nonlocal acc, nacc
        while nacc >= 8:
            byte = (acc >> (nacc - 8)) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
            nacc -= 8
        acc &= (1 << nacc) - 1

    data = bytearray()
    for sym in syms:
        if sym[0] == "rst":
            if nacc % 8:
                pad = 8 - nacc % 8
                acc, nacc = (acc << pad) | ((1 << pad) - 1), nacc + pad
            flush_bits()
            out += bytes([0xFF, 0xD0 + (sym[1] & 7)])
            continue
        code, length = tables[sym[0]][2][sym[1]]
        acc, nacc = (acc << length) | code, nacc + length
        if sym[3]:
            acc, nacc = (acc << sym[3]) | sym[2], nacc + sym[3]
        flush_bits()
    if nacc:
        pad = 8 - nacc
        acc, nacc = (acc << pad) | ((1 << pad) - 1), nacc + pad
        flush_bits()
    data = bytes(out)

    def seg(marker, body):
        return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body

    head = b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for i, q in enumerate(qts):
        head += seg(0xDB, bytes([i]) + bytes(q.astype(np.uint8)))
    comps = bytes([1, (f << 4) | f, 0, 2, 0x11, 1, 3, 0x11, 1])
    head += seg(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([3])
                + comps)
    for k, (hist, values, _) in enumerate(tables):
        head += seg(0xC4, bytes([((k & 1) << 4) | (k >> 1)] + hist + values))
    if restart:
        head += seg(0xDD, restart.to_bytes(2, "big"))
    head += seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return head + data + b"\xff\xd9"


TOD_SCENES, TOD_TEST_SCENES, TOD_BATCH, TOD_VIEWS = 8, 1, 16, 7
# phases 28-31 run on FILES_DEVICE at EVAL_HW (both settable, so that the
# phases can be tried on the CPU at a toy size)
FILES_DEVICE = "cuda"
# a UCN step on the card against its CPU copy at 96x128: every loss term and
# the global gradient norm within UCN_CPU_TOL of the CPU's (the SEGNET's
# convolutions in fp32 with TF32 off on both; cuDNN and the CPU sum in other
# orders; a layout or loss fault shows as O(0.1))
UCN_CPU_TOL = 1e-3


def sync():
    if FILES_DEVICE == "cuda":
        torch.cuda.synchronize()


def host_ms(fn, reps=15):
    """Median wall ms of fn() over reps calls (host work: no sync)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rendered_views(n, seed=0, chunk=16):
    """n OCID-style frames rendered on the card (render_eval_frames), in
    chunks: (bgr uint8, label int32 objects 1.., table bool, xyz with NaN)."""
    parts = [render_eval_frames(min(chunk, n - s), seed + s) for s in range(0, n, chunk)]
    return tuple(np.concatenate([p[i] for p in parts]) for i in range(4))


def jpeg_check_phase():
    """28. JPEG files of rendered 480x640 frames written by encode_jpeg
    (4:2:0 q90, 4:4:4 q95, 4:2:0 with restart markers every 7 MCUs): the
    native decoder equals the numpy twin bit for bit, both near the frame
    encoded; decode ms a frame of each."""
    from unseenobjectswithmeanshift_torch.utils.jpeg import decode_jpeg

    bgr = rendered_views(3, seed=40)[0]
    res = {}
    for i, (tag, kw) in enumerate((("420_q90", dict(quality=90, subsample=True)),
                                   ("444_q95", dict(quality=95, subsample=False)),
                                   ("420_q90_rst7", dict(quality=90, subsample=True,
                                                         restart=7)))):
        t0 = time.perf_counter()
        data = encode_jpeg(bgr[i], **kw)
        enc_s = time.perf_counter() - t0
        got = decode_jpeg(data)
        t0 = time.perf_counter()
        twin = decode_jpeg(data, backend="numpy")
        twin_s = time.perf_counter() - t0
        if not np.array_equal(got, twin):
            raise AssertionError(f"jpeg_check {tag}: the native decoder differs from its numpy "
                                 f"twin at {int((got != twin).sum())} samples")
        err = float(np.abs(got.astype(np.int64) - bgr[i]).mean())
        assert got.shape == (*EVAL_HW, 3) and err < 8, f"jpeg_check {tag}: mean error {err}"
        ms = host_ms(lambda: decode_jpeg(data))
        res[tag] = {"bytes": len(data), "native_ms": ms, "numpy_s": twin_s,
                    "encode_s": enc_s, "mean_abs_err": err}
        sync_print(f"jpeg_check {tag}: {len(data)} bytes, native == numpy twin bit for bit, "
                   f"mean |decoded - frame| {err:.2f}; decode native {ms:.2f} ms a frame, "
                   f"numpy twin {twin_s:.2f} s, encode {enc_s:.2f} s [{CARD}; host CPU]")
    return res


def augment_check_phase():
    """29. Each augmentation and crop resize of the TOD reader on a rendered
    480x640 frame through the native path and its numpy twin, from one
    RandomState each: equal bit for bit (tests/test_torch_augmentation.py
    holds both to cv2 and the JAX functions). ms of each, native / twin."""
    from unseenobjectswithmeanshift_torch.data import augmentation as aug
    from unseenobjectswithmeanshift_torch.data import image_ops
    from unseenobjectswithmeanshift_torch.data.datasets import fov_intrinsics

    bgr, _, _, xyz = rendered_views(1, seed=41)
    bgr, xyz = bgr[0], np.nan_to_num(xyz[0])
    depth = xyz[..., 2].copy()
    i = fov_intrinsics()
    xyz = compute_xyz(torch.from_numpy(depth), i["fx"], i["fy"], i["x_offset"],
                      i["y_offset"]).numpy()
    h, w = EVAL_HW
    crop = (slice(h // 5, h * 4 // 5), slice(w // 4, w * 2 // 3))
    cases = {
        "dropout_random_ellipses": lambda b, r: aug.dropout_random_ellipses(depth, rng=r,
                                                                           backend=b),
        "add_noise_to_xyz (cubic)": lambda b, r: aug.add_noise_to_xyz(xyz, depth, rng=r,
                                                                      backend=b),
        "chromatic_transform (HLS)": lambda b, r: aug.chromatic_transform(bgr, rng=r,
                                                                          backend=b),
        "add_noise": lambda b, r: aug.add_noise(bgr, rng=r, backend=b),
        **{f"motion_blur_{s}{'h' if h else 'v'}": (
            lambda b, r, s=s, h=h: image_ops.filter_line_u8(bgr, s, h, b))
           for s in (3, 15) for h in (True, False)},
        "crop_resize_linear_u8": lambda b, r: image_ops.resize_linear_u8(bgr[crop], 224, 224, b),
    }
    res = {}
    for name, fn in cases.items():
        out, ms = {}, {}
        for b in ("native", "numpy"):
            t0 = time.perf_counter()
            out[b] = fn(b, np.random.RandomState(5))
            ms[b] = (time.perf_counter() - t0) * 1e3
        if out["native"].shape != out["numpy"].shape or not np.array_equal(out["native"],
                                                                           out["numpy"]):
            raise AssertionError(f"augment_check {name}: native and numpy twin differ")
        res[name] = ms
    lab = np.random.RandomState(6).randint(0, 9, (297, 291)).astype(np.int32)
    near = image_ops.resize_nearest(lab, 224, 224)
    assert near.shape == (224, 224) and set(np.unique(near)) <= set(np.unique(lab))
    sync_print("augment_check: native == numpy twin bit for bit on a rendered 480x640 frame; "
               "ms native / twin: " + ", ".join(f"{k} {v['native']:.1f} / {v['numpy']:.1f}"
                                                for k, v in res.items()) + f" [{CARD}; host CPU]")
    return res


def write_tod_tree(d, seed=0):
    """A TOD tree of TOD_SCENES training and TOD_TEST_SCENES test scenes of
    7 views, rendered on the card at 480x640: rgb_*.jpeg (encode_jpeg,
    4:2:0 q90), depth_*.png (uint16 mm, 0 where the depth is missing),
    segmentation_*.png (8-bit grey: table 1, objects 2..). -> root."""
    from unseenobjectswithmeanshift_torch.utils.image_io import write_png

    n = (TOD_SCENES + TOD_TEST_SCENES) * TOD_VIEWS
    bgr, label, table, xyz = rendered_views(n, seed=seed)
    depth = np.nan_to_num(xyz[..., 2] * 1000).round().clip(0, 65535).astype(np.uint16)
    seg = np.where(label > 0, label + 1, np.where(table, 1, 0)).astype(np.uint8)
    for k in range(n):
        s, v = divmod(k, TOD_VIEWS)
        split = "training_set" if s < TOD_SCENES else "test_set"
        scene = os.path.join(d, split, f"scene_{s:05d}")
        os.makedirs(scene, exist_ok=True)
        with open(os.path.join(scene, f"rgb_{v:05d}.jpeg"), "wb") as f:
            f.write(encode_jpeg(bgr[k], quality=90))
        write_png(os.path.join(scene, f"depth_{v:05d}.png"), depth[k])
        write_png(os.path.join(scene, f"segmentation_{v:05d}.png"), seg[k])
    return d


def loader_rate(root):
    """Samples a second of the TOD reader's training loader through its one
    producer thread, as train_net runs it (B=16, augmentations on, batches
    copied to the card), over one epoch; and the reader's parts on one
    sample, ms."""
    from unseenobjectswithmeanshift_torch.data import augmentation as aug
    from unseenobjectswithmeanshift_torch.data.datasets import TableTopObject
    from unseenobjectswithmeanshift_torch.data.loader import BatchLoader
    from unseenobjectswithmeanshift_torch.utils.image_io import (
        IMREAD_ANYDEPTH, imread, imread_indexed,
    )

    ds = TableTopObject(root, "train", seed=0)
    loader = BatchLoader(ds, TOD_BATCH, seed=0, device=FILES_DEVICE, masks=False)
    t0 = time.perf_counter()
    n = 0
    for b in loader:
        n += b["image"].shape[0]
    sync()
    rate = n / (time.perf_counter() - t0)
    scene = ds.scene_dirs[0]
    rng = np.random.RandomState(0)
    parts = {}

    def part(name, fn):
        t = time.perf_counter()
        out = fn()
        parts[name] = (time.perf_counter() - t) * 1e3
        return out

    part("label png", lambda: imread_indexed(os.path.join(scene, "segmentation_00000.png")))
    im = part("jpeg", lambda: imread(os.path.join(scene, "rgb_00000.jpeg")))
    d16 = part("depth png", lambda: imread(os.path.join(scene, "depth_00000.png"),
                                           IMREAD_ANYDEPTH))
    depth = (d16 / 1000.0).astype(np.float32)
    depth = part("gamma + ellipses", lambda: aug.dropout_random_ellipses(
        aug.add_noise_to_depth(depth, rng=rng), rng=rng))
    i = ds.intrinsics
    xyz = compute_xyz(torch.from_numpy(depth), i["fx"], i["fy"], i["x_offset"],
                      i["y_offset"]).numpy()
    part("xyz noise (cubic)", lambda: aug.add_noise_to_xyz(xyz, depth, rng=rng))
    im = part("chromatic (HLS)", lambda: aug.chromatic_transform(im, rng=rng))
    part("noise", lambda: aug.add_noise(im, rng=rng))
    part("whole sample", lambda: ds[3])
    return rate, parts


def ucn_cpu_agreement():
    """One UCN train forward and backward of the full-width RGB-D SEGNET at
    96x128, B=2, on the card and on a CPU copy (same weights and batch):
    loss, intra, inter and the global gradient norm (UCN_CPU_TOL)."""
    from unseenobjectswithmeanshift_torch.train.ucn import UCNTrainer

    cfg = get_config("tabletop_pretrained")
    tr = UCNTrainer(cfg, 1, device=FILES_DEVICE)
    cpu = UCNTrainer(cfg, 1, device="cpu", model=copy.deepcopy(tr.model).cpu())
    batch = SyntheticDeviceLoader(2, height=96, width=128, max_gt=cfg.loss.max_gt_instances,
                                  seed=0, device=FILES_DEVICE).batch_at(0)
    got, want = {}, {}
    for t, b, out in ((tr, batch, got), (cpu, {k: v.cpu() for k, v in batch.items()}, want)):
        t.optimizer.zero_grad()
        loss, intra, inter = t.loss(b)
        loss.backward()
        out.update(loss=loss.item(), intra=intra.item(), inter=inter.item(),
                   grad_norm=grad_norm(t.model))
    dev = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-3) for k in want}
    worst = max(dev, key=dev.get)
    sync_print(f"train_files ucn step 96x128 B=2, card vs CPU: {got} vs {want}; worst relative "
               f"deviation {dev[worst]:.2e} ({worst}; tol {UCN_CPU_TOL:.0e})")
    if dev[worst] > UCN_CPU_TOL:
        raise AssertionError("the UCN step on the card disagrees with its CPU copy")
    return {"card": got, "cpu": want, "deviation": dev}


def ucn_step_ms(root, crop=False, steps=4, warmup=2):
    """Median ms of a UCN train step (B=16, fp32) on one batch of the TOD
    reader (whole image, or SYN_CROP 224^2 crops), synchronized, and the
    peak memory in GiB."""
    from unseenobjectswithmeanshift_torch.data.datasets import TableTopObject
    from unseenobjectswithmeanshift_torch.data.loader import BatchLoader
    from unseenobjectswithmeanshift_torch.train.ucn import UCNTrainer

    ds = TableTopObject(root, "train", syn_crop=crop, seed=0)
    batch = next(iter(BatchLoader(ds, TOD_BATCH, seed=0, device=FILES_DEVICE, masks=False,
                                  prefetch=0)))
    tr = UCNTrainer(get_config("tabletop_pretrained"), 1, device=FILES_DEVICE)
    on_card = FILES_DEVICE == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(warmup + steps):
        sync()
        t0 = time.perf_counter()
        losses.append(tr.train_step(batch)["loss"])
        sync()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    assert all(math.isfinite(v) for v in losses), losses
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
    return statistics.median(times), peak, losses


def records(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def train_net_run(tag, argv, profile=False):
    """cli.train_net.main(argv) -> (seconds, records, device busy ms or None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from unseenobjectswithmeanshift_torch.cli import train_net

    t0 = time.perf_counter()
    busy = None
    if profile:
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            train_net.main(argv)
            sync()
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA) / 1e3
    else:
        train_net.main(argv)
    seconds = time.perf_counter() - t0
    out = argv[argv.index("--output") + 1]
    recs = records(out)
    bad = [r for r in recs if r["kind"] == "train" and not math.isfinite(r["loss"])]
    assert not bad, f"train_files {tag}: non-finite losses {bad}"
    return seconds, recs, busy


def serve_ucn_checkpoint(path, root):
    """The train_net checkpoint served through build_ucn_predictor("ucn_rgbd_add",
    checkpoint=path) on one clean test-split frame: FPS and connected-
    components launches counted (stage 1 always; stage 2 where crops are)."""
    from unseenobjectswithmeanshift_torch.data.datasets import TableTopObject

    s = TableTopObject(root, "test", seed=1, use_augmentation=False, chromatic=False,
                       add_noise=False)[0]
    pred = build_ucn_predictor("ucn_rgbd_add", checkpoint=path, device=FILES_DEVICE)
    image = torch.from_numpy(s["image"][None]).to(FILES_DEVICE)
    xyz = torch.from_numpy(s["xyz"][None]).to(FILES_DEVICE)
    zero_counts()
    labels, refined = pred(image, xyz)
    sync()
    launches = kernel_counts()
    assert labels.shape == (1, *EVAL_HW) and labels.dtype == torch.int32
    if FILES_DEVICE == "cuda":          # CPU tensors take the plain versions: no launch
        assert launches["fps_seeds"] >= 1 and launches["connected_components"] >= 1, launches
    return {"launches": launches, "instances": int(labels.max()),
            "instances_refined": int(refined.max())}


def train_files_main_phase(results):
    """30. Training on files on the card: a TOD tree of rendered scenes,
    the loader's rate and parts, cli.train_net on it (2 epochs whole image
    fp32 at B=16 with a profiled epoch, 1 epoch --crop, 1 epoch --bf16, a
    run resumed at epoch 1 that pulls the uninterrupted run's batches),
    the last checkpoint served through a ucn_* preset, UCN step ms and
    peak memory, the card against its CPU copy, and cli.train_msmformer
    --dataset tabletop_object with --eval-period (row 1 launches counted)."""
    import tempfile

    from unseenobjectswithmeanshift_torch.cli import train_msmformer

    d = tempfile.mkdtemp(prefix="uoms_tod_")
    try:
        root = os.path.join(d, "tod")
        t0 = time.perf_counter()
        write_tod_tree(root)
        results["tree_s"] = time.perf_counter() - t0
        sync_print(f"train_files: TOD tree of {TOD_SCENES} + {TOD_TEST_SCENES} scenes x "
                   f"{TOD_VIEWS} views at 480x640 rendered and written in "
                   f"{results['tree_s']:.1f} s")
        rate, parts = loader_rate(root)
        results["loader"] = {"samples_per_s": rate, "parts_ms": parts}
        sync_print(f"train_files loader: {rate:.2f} samples/s through one producer thread "
                   f"(B={TOD_BATCH}, augmentations on, copied to the card: "
                   f"{TOD_BATCH / rate * 1e3:.0f} ms a batch); one sample's parts ms: "
                   + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + f" [{CARD}; host CPU]")
        results["cpu_agreement"] = ucn_cpu_agreement()
        for crop in (False, True):
            ms, peak, losses = ucn_step_ms(root, crop)
            results["step_crop" if crop else "step_whole"] = {
                "ms": ms, "peak_gib": peak, "losses": losses}
            sync_print(f"train_files ucn step B={TOD_BATCH} fp32 "
                       f"{'224^2 crops' if crop else '480x640'}: {ms:.1f} ms median, peak "
                       f"{peak:.2f} GiB, losses {[round(v, 4) for v in losses]} [{CARD}]")
            torch.cuda.empty_cache()
        common = ["--root", root, "--batch", str(TOD_BATCH), "--log-period", "1",
                  "--log-batches", "--device", FILES_DEVICE]
        a, b = os.path.join(d, "a"), os.path.join(d, "b")
        secs, rec_a, busy = train_net_run("fp32", common + ["--epochs", "2", "--output", a],
                                          profile=True)
        steps = sum(1 for r in rec_a if r["kind"] == "train")
        results["train_net_fp32"] = {"seconds": secs, "steps": steps, "device_busy_ms": busy,
                                     "device_idle_share": max(0.0, 1 - busy / (secs * 1e3))}
        sync_print(f"train_files train_net fp32: 2 epochs, {steps} steps at B={TOD_BATCH} in "
                   f"{secs:.1f} s (profiled) ({secs / steps * 1e3:.0f} ms a step with the "
                   f"loader and the epoch saves); device busy {busy:.0f} ms, idle share "
                   f"{results['train_net_fp32']['device_idle_share']:.2f} [{CARD}]")
        infix = "seg_resnet34_8s_embedding_cosine_rgbd_add"
        secs, rec_b, _ = train_net_run("resumed", common + [
            "--epochs", "2", "--output", b, "--start-epoch", "1", "--pretrained",
            os.path.join(a, f"{infix}_epoch_1.checkpoint.pth")])
        want = [(r["files"], r["checksum"]) for r in rec_a if r["kind"] == "batch"
                and r["epoch"] == 2]
        got = [(r["files"], r["checksum"]) for r in rec_b if r["kind"] == "batch"]
        if got != want or not got:
            raise AssertionError(f"train_files: the run resumed at epoch 1 pulled other batches "
                                 f"than the uninterrupted run: {got} vs {want}")
        loss_a = [r["loss"] for r in rec_a if r["kind"] == "train" and r["epoch"] == 2]
        loss_b = [r["loss"] for r in rec_b if r["kind"] == "train"]
        results["resume"] = {"batches": len(got), "losses": loss_a, "losses_resumed": loss_b}
        sync_print(f"train_files resume at epoch 1: the same {len(got)} batches (file names "
                   f"and checksums) as the uninterrupted run; epoch-2 losses {loss_a} vs "
                   f"resumed {loss_b} ({secs:.1f} s)")
        for tag, extra in (("crop", ["--crop"]), ("bf16", ["--bf16"])):
            out = os.path.join(d, tag)
            secs, recs, _ = train_net_run(tag, common + ["--epochs", "1", "--output", out]
                                          + extra)
            losses = [r["loss"] for r in recs if r["kind"] == "train"]
            results[f"train_net_{tag}"] = {"seconds": secs, "losses": losses}
            sync_print(f"train_files train_net --{tag}: 1 epoch, {len(losses)} steps in "
                       f"{secs:.1f} s, losses {[round(v, 4) for v in losses]} [{CARD}]")
        torch.cuda.empty_cache()
        results["served"] = serve_ucn_checkpoint(
            os.path.join(a, f"{infix}_epoch_2.checkpoint.pth"), root)
        sync_print(f"train_files: the epoch-2 checkpoint served by build_ucn_predictor("
                   f"'ucn_rgbd_add', checkpoint=...): {results['served']}")
        torch.cuda.empty_cache()
        msm = os.path.join(d, "msm")
        n_eval = 4
        zero_counts()
        t0 = time.perf_counter()
        train_msmformer.main(["--dataset", "tabletop_object", "--root", root, "--iters", "4",
                              "--batch", "4", "--eval-period", "2", "--eval-samples",
                              str(n_eval), "--log-period", "1", "--checkpoint-period", "1000",
                              "--fresh", "--device", FILES_DEVICE, "--output", msm])
        launches = kernel_counts()
        recs = records(msm)
        evals = [r for r in recs if r["kind"] == "eval"]
        trains = [r for r in recs if r["kind"] == "train"]
        assert [r["iter"] for r in evals] == [2, 4] and len(trains) == 4
        assert all(math.isfinite(r["total_loss"]) for r in trains)
        if FILES_DEVICE == "cuda":
            assert launches["fused_uoms_cross_attention"] == 6 * n_eval * len(evals), launches
        results["train_msmformer"] = {"seconds": time.perf_counter() - t0, "launches": launches,
                                      "evals": evals}
        sync_print(f"train_files train_msmformer --dataset tabletop_object: 4 steps at B=4, "
                   f"2 evaluations of {n_eval} test-split frames, "
                   f"{launches['fused_uoms_cross_attention']} cross-attention launches (6 a "
                   f"frame), Objects F {[round(r['Objects F-measure'], 4) for r in evals]} "
                   f"({results['train_msmformer']['seconds']:.1f} s) [{CARD}]")
    finally:
        import shutil

        shutil.rmtree(d, ignore_errors=True)
    return results


def demo_cli_phase():
    """31. cli.demo.main on a folder of two rendered frames written as the
    demo reads them (JPEG colour, uint16 depth PNG, camera_params.json),
    with cv2 unimportable: each written -label.png equals the binary image
    of label_frame's labels on the same predictor and sample."""
    import tempfile

    from unseenobjectswithmeanshift_torch.cli import demo
    from unseenobjectswithmeanshift_torch.utils.image_io import (
        IMREAD_ANYDEPTH, imread, write_png,
    )
    from unseenobjectswithmeanshift_torch.utils.preprocess import fov_intrinsics, read_sample

    bgr, _, _, xyz = rendered_views(2, seed=50)
    with tempfile.TemporaryDirectory() as d:
        for k in range(2):
            with open(os.path.join(d, f"{k:06d}-color.jpg"), "wb") as f:
                f.write(encode_jpeg(bgr[k], quality=92))
            write_png(os.path.join(d, f"{k:06d}-depth.png"),
                      np.nan_to_num(xyz[k][..., 2] * 1000).round().astype(np.uint16))
        params = fov_intrinsics()
        with open(os.path.join(d, "camera_params.json"), "w") as f:
            json.dump(params, f)
        argv = ["--imgdir", d, "--device", FILES_DEVICE]
        demo.main(argv)
        pred, _ = demo.build_predictor(argparse.Namespace(  # the demo's defaults
            config=None, checkpoint=None, checkpoint_crop=None, bf16=False, no_depth=False,
            key_stride=1, device=FILES_DEVICE))
        for k in range(2):
            s = read_sample(os.path.join(d, f"{k:06d}-color.jpg"),
                            os.path.join(d, f"{k:06d}-depth.png"), params, device=FILES_DEVICE)
            refined, _ = demo.label_frame(pred, s["image"], s["xyz"])
            want = (np.clip(refined, 0, 1) * 255).astype(np.uint8)
            got = imread(os.path.join(d, f"{k:06d}-color-label.png"), IMREAD_ANYDEPTH)
            if got is None or not np.array_equal(got, want):
                raise AssertionError(f"demo_cli: frame {k}'s label PNG differs from label_frame")
    sync_print("demo_cli: cli.demo.main read 2 JPEG + depth PNG frames and wrote label PNGs "
               "equal to label_frame's labels, with cv2 and PIL unimportable")


def train_eval_scoring(args, pred):
    """The scoring of --eval-period on a network that finds instances (four
    training steps leave the network finding none, and the metric then
    returns its constants): train_msmformer.evaluate_scenes on the held-out
    scenes of the parsed train_msmformer flags ``args`` with the whole-image
    network of ``pred`` (a decisive_predictor), held equal to the serving
    path's stage-1 labels of each scene (pred(image, xyz, refine=False))
    scored by multilabel_metrics and averaged; at least one object
    detected. -> the averaged metrics."""
    from unseenobjectswithmeanshift_torch.cli import train_msmformer
    from unseenobjectswithmeanshift_torch.utils.evaluation import (
        aggregate_metrics, multilabel_metrics,
    )

    scenes = train_msmformer.eval_scenes(args, pred.cfg, train_msmformer.image_hw(args))
    want = []
    for image, xyz, label in scenes:            # before evaluate_scenes: it ends in train()
        labels, _ = pred(image, xyz, refine=False)
        want.append(multilabel_metrics(labels[0].cpu().numpy(), label))
    want = aggregate_metrics(want)
    got = train_msmformer.evaluate_scenes(pred.model, pred.cfg, scenes)
    if not metrics_equal(got, want):
        raise AssertionError(f"train_eval: evaluate_scenes {got} differs from the serving "
                             f"path's labels scored {want}")
    assert got["obj_detected"] > 0, f"train_eval: the decisive network detected nothing: {got}"
    return got


def train_eval_phase():
    """27. cli.train_msmformer at 480x640, B=4, 4 steps with --eval-period 2
    --eval-samples 8: two finite eval records beside the train records; then
    the same scoring on a decisive network (train_eval_scoring)."""
    import tempfile

    from unseenobjectswithmeanshift_torch.cli import train_msmformer

    argv = ["--iters", "4", "--batch", "4", "--eval-period", "2", "--eval-samples", "8",
            "--log-period", "1", "--checkpoint-period", "1000", "--fresh",
            "--device", EVAL_DEVICE]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        train_msmformer.main(["--output", d] + argv)
        with open(os.path.join(d, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
    evals = [r for r in records if r["kind"] == "eval"]
    trains = [r for r in records if r["kind"] == "train"]
    sync_print(f"train_eval: {len(trains)} train and {len(evals)} eval records in "
               f"{time.perf_counter() - t0:.1f} s [{CARD}]; eval Objects / Boundary F: "
               + ", ".join(f"iter {r['iter']}: {r['Objects F-measure']:.4f} / "
                           f"{r['Boundary F-measure']:.4f}" for r in evals))
    assert [r["iter"] for r in evals] == [2, 4] and len(trains) == 4
    for r in evals:
        bad = [k for k, v in r.items() if k != "kind" and not math.isfinite(v)]
        assert not bad, f"eval record at iter {r['iter']} has non-finite {bad}"
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    decisive = train_eval_scoring(train_msmformer.parse_args(["--output", "unused"] + argv),
                                  decisive_predictor(seed=0, device=EVAL_DEVICE))
    sync_print(f"train_eval: evaluate_scenes on decisive_predictor's network equal to the "
               f"serving path's stage-1 labels scored, {decisive['obj_detected']:.2f} objects "
               f"detected a scene of {decisive['obj_gt']:.2f}; Objects / Boundary F "
               f"{decisive['Objects F-measure']:.4f} / {decisive['Boundary F-measure']:.4f} "
               f"({time.perf_counter() - t0:.1f} s) [{CARD}]")
    return {"evals": evals, "seconds": seconds, "decisive": decisive}


def main(argv=None):
    p = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    p.add_argument("--weights", help="a .npz export of one MSMFormer release "
                   "(scripts/export_release_npz.py): tile_skip_main and bf16_main run on it "
                   "too, train_main fine-tunes it and eval_main evaluates it")
    opts = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print("tf32: disabled for matmul and cudnn (fp32 reference numerics); bf16 matmuls "
          "accumulate in fp32", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    global CARD
    CARD = smi
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
    seed_limits = {}
    fps_groups_check(seed_limits)
    seeds_200_check(seed_limits)
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

    # 19-20. bf16 serving
    t0 = time.perf_counter()
    bf16_results = bf16_check_phase()
    phase_done("bf16_check", t0)
    t0 = time.perf_counter()
    bf16_main = {}
    bf16_launches, bf16_skip_launches = bf16_main_phase(bf16_main, opts.weights)
    phase_done("bf16_main", t0)

    # 21-22. the standard-backbone family
    t0 = time.perf_counter()
    r50_results = r50_check_phase()
    phase_done("r50_check", t0)
    t0 = time.perf_counter()
    r50_main = {}
    r50_launches, r50_bf16_launches = r50_main_phase(r50_main)
    phase_done("r50_main", t0)

    # 23-24. training
    t0 = time.perf_counter()
    train_results = {"check": train_check_phase()}
    torch.cuda.empty_cache()
    phase_done("train_check", t0)
    t0 = time.perf_counter()
    train_results["main"] = train_main_phase({}, opts.weights)
    torch.cuda.empty_cache()
    phase_done("train_main", t0)

    # 25-27. dataset evaluation
    with without_cv2_or_pil():
        t0 = time.perf_counter()
        eval_results = {"check": eval_check_phase()}
        phase_done("eval_check", t0)
        t0 = time.perf_counter()
        eval_results["main"] = eval_main_phase({}, opts.weights)
        torch.cuda.empty_cache()
        phase_done("eval_main", t0)
        t0 = time.perf_counter()
        eval_results["train_eval"] = train_eval_phase()
        torch.cuda.empty_cache()
        phase_done("train_eval", t0)

        # 28-31. training on files
        t0 = time.perf_counter()
        files_results = {"jpeg_check": jpeg_check_phase()}
        phase_done("jpeg_check", t0)
        t0 = time.perf_counter()
        files_results["augment_check"] = augment_check_phase()
        phase_done("augment_check", t0)
        t0 = time.perf_counter()
        files_results["main"] = train_files_main_phase({})
        torch.cuda.empty_cache()
        phase_done("train_files_main", t0)
        t0 = time.perf_counter()
        demo_cli_phase()
        torch.cuda.empty_cache()
        phase_done("demo_cli", t0)
    ev = eval_results["main"]
    eval_fp32 = sum(ev[k]["launches"]["fused_uoms_cross_attention"]
                    for k in ("msmformer_ocid", "msmformer_osd"))
    eval_ucn = ev["ucn_ocid"]["launches"]
    files_xattn = files_results["main"]["train_msmformer"]["launches"]
    files_xattn = files_xattn["fused_uoms_cross_attention"]
    served = files_results["main"]["served"]["launches"]

    s1r = results["stage1_B1_K307200"]["separable"]
    kernels = [{
        "name": "fused_uoms_cross_attention",
        "route": "cuda",
        "source": "unseenobjectswithmeanshift_torch/csrc/fused_cross_attention.cu",
        "replaces": "unseenobjectswithmeanshift_tpu/ops/fused_cross_attention.py:334",
        "launches": launches + r50_launches + eval_fp32 + files_xattn,
        "launches_by_path": {"main": launches, "r50_main": r50_launches,
                             "eval_main": eval_fp32, "train_files_main": files_xattn},
        "max_abs_err": max([x["max_abs_err"] for r in results.values() for x in r.values()]
                           + [r["max_abs_err"] for r in r50_results.values()]),
        "ms": s1r["ms"], "plain_ms": s1r["plain_ms"], "bound_ms": s1r["bound_ms"],
        "bound_by": s1r["bound_by"], "library_ms": None,
        "ms_general_pos": results["stage1_B1_K307200"]["general"]["ms"],
        "bound_fp32_ms": s1r["bound_fp32_ms"],
        "shapes": results, "mask_checks": mask_checks,
        "key_stride_shapes": stride_results,
        "launches_key_stride": {k: preset_launches[k]["fused_uoms_cross_attention"]
                                for k in ("key_stride_2", "key_stride_3")},
        "r50_shapes": r50_results,
        "r50_main": r50_main,
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
            "launches": (sum(p[name] for p in ucn_launches.values()) + eval_ucn[name]
                         + served[name]),
            "launches_by_path": {**{p: v[name] for p, v in ucn_launches.items()},
                                 "eval_main": eval_ucn[name], "train_files_main": served[name]},
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
        "launches": (sum(p["connected_components"] for p in ucn_launches.values())
                     + eval_ucn["connected_components"] + served["connected_components"]),
        "launches_by_path": {**{p: v["connected_components"] for p, v in ucn_launches.items()},
                             "eval_main": eval_ucn["connected_components"],
                             "train_files_main": served["connected_components"]},
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
    b1 = bf16_results["stage1_B1_K307200"]["separable"]
    bk = bf16_results["tile_skip_stage1_B1_K307200_concentrated"]
    for name, line, entry, launched in (
            ("fused_uoms_cross_attention(bf16)", 334, b1,
             bf16_launches + r50_bf16_launches + ev["msmformer_bf16_ocid"]["launches"]["bf16"]),
            ("fused_uoms_cross_attention(bf16, tile_skip=True)", 483, bk, bf16_skip_launches)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "unseenobjectswithmeanshift_torch/csrc/fused_cross_attention.cu",
            "design": "xattn_partial_kernel<bf16>: the fp32 kernel's launch plan, mask words, "
                      "guard and tile skipping; every product once on mma.sync m16n8k16 .bf16 "
                      "with fp32 accumulation; k^, p and v rounded to bf16 as the JAX kernel",
            "replaces": f"unseenobjectswithmeanshift_tpu/ops/fused_cross_attention.py:{line}",
            "launches": launched,
            "max_abs_err": (max([bf16_results[n][f]["max_abs_err"] for n in BF16_SHAPES
                                 for f in FORMS]
                                + [r["bf16_max_abs_err"] for r in r50_results.values()])
                            if line == 334 else bk["max_abs_err"]),
            **({"launches_by_path": {
                "bf16_main": bf16_launches, "r50_main": r50_bf16_launches,
                "eval_main": ev["msmformer_bf16_ocid"]["launches"]["bf16"]}}
               if line == 334 else {}),
            "max_abs_err_of": "bf16 output against the bf16 twin (tol 2e-2)",
            **{k: entry[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
            "fp32_kernel_ms": entry.get("fp32_kernel_ms", entry.get("dense_ms")),
            "ptxas": {k: v for k, v in bf16_results["ptxas"].items() if "bf16" in k},
            "shapes": {k: v for k, v in bf16_results.items() if k != "ptxas"},
            "main_path": bf16_main,
        })
    print(json.dumps({"presets_main": preset_results, "grouped_towers": grouped_results,
                      "stream_main": stream_results, "stage1_no_sync": no_sync,
                      "seed_limits": seed_limits, "train": train_results,
                      "eval": eval_results, "files": files_results}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
