#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--weights PATH]

Phases, each followed by a ``phase=<name> seconds=<t>`` line:

1. build    nvcc builds every CUDA source of the port (csrc/*.cu, sm_90a).
2. check    the fused cross-attention kernel against its plain PyTorch
            version (evaluated in fp64) at the shapes of the main path:
            B=1 whole image (K = 480*640), B=8 compacted crops with 2 absent
            and B=20 crops, the most stage 2 can get (K = 224*224), with
            queries whose mask removes every key (the guard).
3. time     kernel and plain version, CUDA events, 3 warm-up runs then the
            median of 10.
4. main     two-stage inference at full width (tabletop_pretrained +
            crop_tabletop_pretrained, 480x640, random weights from seed 0)
            through ``build_two_stage_predictor``; counts the kernel's
            launches per stage, checks the outputs, and checks the kernel
            once more at the crop count that stage 2 ran.
5. ucn_check  the farthest-point seeding kernel and the hill-climbing kernel
            against their plain versions at B=1/N=307,200 (stage 1) and
            B=20/N=50,176 (the most crops stage 2 can get), on seeded
            clustered unit vectors with duplicated rows (exact ties): the
            seeds equal X[idx] bit for bit; at every step the kernel's index
            attains the fp64 maximum of the running minimum distance (from
            the kernel's own earlier seeds) within 1e-6; duplicated rows go
            to the lowest index; the first step where the chain departs from
            the fp32 plain version is printed with its gap; the climbed seeds
            agree with the plain version in fp64 within CLIMB_TOL.
6. ucn_time kernel, plain and bound ms of both kernels at both shapes.
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
            E=256, guard rows present) and held to their plain versions in
            fp64 (TOL); kernel, plain, bound and library ms.

The line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Any failure ends the run with a
traceback and a non-zero exit code. Without CUDA the script fails at once.
"""

import argparse
import contextlib
import json
import math
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
    TILE_KEYS, fused_uoms_cross_attention, fused_uoms_cross_attention_plain, tile_occupancy,
    unmasked_keys,
)
from unseenobjectswithmeanshift_torch.ops.pallas_attention import (
    fused_masked_hypersphere_attention, fused_masked_hypersphere_attention_plain,
    masked_hypersphere_attention, masked_hypersphere_attention_plain,
)
from unseenobjectswithmeanshift_torch.ops.mean_shift import connected_components, seed_hill_climbing
from unseenobjectswithmeanshift_torch.ops.mean_shift_kernels import (
    fps_seeds, fps_seeds_plain, mean_shift_seeds, mean_shift_seeds_plain,
)
from unseenobjectswithmeanshift_torch.pipeline.factory import (
    build_two_stage_predictor, build_ucn_predictor,
)
from unseenobjectswithmeanshift_torch.utils.preprocess import compute_xyz
from unseenobjectswithmeanshift_torch.weights import load_npz_variables

# Kernel vs plain: the kernel (fp32) is held against its plain version
# evaluated in fp64 on the same inputs. The plain version in fp32 is no
# sharper a yardstick than the kernel: its cuBLAS sums over 307,200 keys carry
# ~1e-4 of rounding at stage 1 (measured on the H100), while the kernel sits
# ~1e-6 from the fp64 result. The mask logits me . mf of the check inputs are
# exact in fp32 (small integers times multiples of 1/4), so no key is masked
# differently on the two sides. 2e-5 leaves 20x over the kernel's measured
# error; an indexing or masking fault shows as O(0.1). The difference from the
# fp32 plain version is printed too.
TOL = 2e-5
PEAK_FP32_FLOPS = 67e12   # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
H, Q, D, C, CM = 8, 100, 32, 64, 256
E = H * D


def sync_print(*args):
    torch.cuda.synchronize()
    print(*args, flush=True)


def phase_done(name, t0):
    sync_print(f"phase={name} seconds={time.perf_counter() - t0:.3f}")


def make_inputs(B, h, w, absent=(), seed=0):
    """Seeded inputs at the decoder's full width, made on the device. Mask
    features are multiples of 1/4 and mask embeds small integers, so every
    mask logit is exact. Queries 0-3 of every image weight only channel 0,
    which is made positive everywhere, negatively: their mask removes every
    key (the guard)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    K = h * w
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    qn = rn(B, H, Q, D)
    qn = qn / qn.norm(dim=-1, keepdim=True)
    featT = rn(B, C, K) * 0.3
    mfT = torch.round(rn(B, CM, K) * 2.0) / 4.0
    mfT[:, 0] = mfT[:, 0].abs() + 0.25
    me = torch.round(rn(B, Q, CM) * 3.0)
    me[:, :4] = 0.0
    me[:, :4, 0] = -5.0
    posT = position_embedding_sine(h, w, E // 2).reshape(K, E).T.contiguous()
    args = [qn, featT, mfT, me, posT, rn(C, E) * 0.2, rn(C, E) * 0.2, rn(E, E) * 0.1,
            rn(E) * 0.1, rn(E) * 0.1]
    present = torch.ones(B, dtype=torch.bool, device="cuda")
    for b in absent:
        present[b] = False
    return [a.contiguous() for a in args], present


def work(args, present, occ=None):
    """(fp32 operations, bytes) the function needs for these inputs: each input
    read once and the output written once; absent images need no work. With
    occ [B, T] (tile skipping), the k/v projections and the attention run on
    the occupied tiles only, the pos projection on the tiles some image
    occupies, and only those columns of featT and posT are read."""
    qn, featT = args[0], args[1]
    B, K = featT.shape[0], featT.shape[2]
    n = int(present.sum())
    if occ is None:
        occ = present.bool()[:, None].expand(B, -(-K // TILE_KEYS))
    tile_keys = lambda o: min(K, int(o.sum()) * TILE_KEYS)
    k_any = tile_keys(occ.any(0))
    k_img = sum(tile_keys(occ[b]) for b in range(B))
    flops = (2 * k_any * E * E + n * 2 * Q * K * CM
             + k_img * (4 * C * E + 2 * H * Q * D + 2 * H * Q * (D + 1)))
    nbytes = (sum(a.numel() * a.element_size() for a in args) + present.numel()
              + qn.numel() * 4 - (K - k_any) * E * 4 - (B * K - k_img) * C * 4)
    return flops, nbytes


def bound(flops, nbytes):
    """(bound ms, what bounds it): the larger of the operations over the fp32
    peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def check_case(name, B, h, w, absent=()):
    """Kernel against its plain version in fp64 on make_inputs(B, h, w,
    absent); raises when they disagree. -> (args, present, max_abs_err)."""
    args, present = make_inputs(B, h, w, absent)
    got = fused_uoms_cross_attention(*args, present=present)
    want = fused_uoms_cross_attention_plain(*args, present=present)
    want64 = fused_uoms_cross_attention_plain(*[a.double() for a in args], present=present)
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
    sync_print(f"check {name}: max_abs_err={err:.3e} (vs the plain version in fp64, "
               f"tol={TOL:.0e}) vs_plain_fp32={err32:.3e} plain_fp32_vs_fp64={plain_err:.3e} "
               f"worst_query={worst_q} guard_rows={guard_rows} finite={finite} "
               f"absent_zero={absent_zero}")
    if not (err <= TOL and finite and absent_zero and guard_rows > 0):
        raise AssertionError(f"kernel disagrees with its plain version at {name}")
    return args, present, err


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
# kernel's own seeds: its fp32 sums over up to 307,200 weights of at most e^20
# measured 3.7e-7 to 2.4e-6 from fp64 on the H100 (B=1 to B=20); CLIMB_TOL =
# 2e-5 leaves 8x, a wrong weight or a dropped key tile shows as O(0.01). The
# fp32 plain version is itself up to 2.1e-5 from fp64 at B=20.
FPS_TOL = 1e-6
CLIMB_TOL = 2e-5
SEEDS, ITERS, KAPPA, EPSILON, EMBED = 100, 10, 20.0, 0.04, 64


def clustered_unit_vectors(B, N, seed=0, k=12):
    """[B, N, 64] fp32 unit rows around k directions per image, made on the
    device, with exact ties: 1% of the rows copy another row, and 8 isolated
    directions each sit at 3 positions, which the farthest-point chain
    reaches once it has a seed in every cluster. -> (X, first [B] int32,
    groups [8, 3] sorted positions of the isolated rows)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    unit = lambda v: v / v.norm(dim=-1, keepdim=True)
    centers = unit(rn(B, k, EMBED))
    assign = torch.randint(0, k, (B, N, 1), generator=g, device="cuda").expand(B, N, EMBED)
    X = unit(torch.gather(centers, 1, assign) + 0.06 * rn(B, N, EMBED))
    src, dst = torch.randint(0, N, (2, max(1, N // 100)), generator=g, device="cuda")
    X[:, dst] = X[:, src]
    groups = torch.randperm(N, generator=g, device="cuda")[:24].view(8, 3).sort(1).values
    X[:, groups.flatten()] = unit(rn(B, 8, EMBED)).repeat_interleave(3, dim=1)
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


def check_mean_shift(name, B, N, seed=0):
    X, first, groups = clustered_unit_vectors(B, N, seed)
    seeds, idx, gap = check_fps(name, X, first, groups)
    err = check_climb(name, X, first, seeds, idx)
    return (X, first), {"fps_max_gap": gap, "climb_max_abs_err": err}


def mean_shift_work(B, N, climb: bool):
    """(fp32 operations, bytes) of fps_seeds, or of mean_shift_seeds with
    climb=True: X and first read once, seeds and indices written once. FPS
    takes S-1 distance passes (dot, 1 - p, x 0.5, min per row); a climbing
    step takes S N (4d + 2) (dot, x kappa, exp, weighted sum) and S 3d for
    the normalization."""
    flops = B * (SEEDS - 1) * N * (2 * EMBED + 3)
    if climb:
        flops += B * ITERS * SEEDS * (N * (4 * EMBED + 2) + 3 * EMBED)
    nbytes = B * N * EMBED * 4 + B * 4 + B * SEEDS * (EMBED + 1) * 4
    return flops, nbytes


def decisive_ucn_predictor(image, xyz, seed=0, **kwargs):
    """build_ucn_predictor(seed=seed, **kwargs) with random weights made
    decisive: random SEGNET embeddings share a large common component, so a
    scene falls into one cluster. The RGB tower's fc bias of both networks
    is shifted by minus the mean raw (pre-normalization) embedding of
    (image, xyz), which spreads the unit embeddings over the sphere."""
    pred = build_ucn_predictor(seed=seed, **kwargs)
    with torch.no_grad():
        for net in (pred.network, pred.network_crop):
            nchw = lambda t: t.permute(0, 3, 1, 2)
            raw = net.fcn(nchw(image)) + net.fcn_depth(nchw(xyz))
            net.fcn.resnet34_8s.fc.bias -= raw.mean(dim=(0, 2, 3))
    return pred


def msmformer_main_phase(results, t0):
    """4. the MSMFormer two-stage path at full width. -> kernel launches."""
    pred = decisive_predictor(seed=0)
    image, xyz = synthetic_rgbd(seed=0)
    sync_print(f"main: models built and moved, {time.perf_counter() - t0:.1f} s")

    fused_uoms_cross_attention.launches = 0
    s1 = pred.stage1(image, xyz)
    torch.cuda.synchronize()
    n_stage1 = fused_uoms_cross_attention.launches
    refined = pred.refine(s1)
    torch.cuda.synchronize()
    launches = fused_uoms_cross_attention.launches
    n_stage2 = launches - n_stage1
    n_crops = int(sum(int(c.present.sum()) for c in s1.crops))
    labels = s1.labels
    sync_print(f"main: launches stage1={n_stage1} stage2={n_stage2} present_crops={n_crops} "
               f"stage1_instances={int((labels.unique() >= 2).sum())} "
               f"refined_instances={int((refined.unique() >= 1).sum())}")
    assert n_stage1 == 6 and n_stage2 == 6, "the decoder did not launch the kernel once per layer"
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
    results[name] = {"max_abs_err": check_case(name, n_crops, 224, 224)[2]}
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
        want64 = fused_uoms_cross_attention_plain(*[a.double() for a in args], present=present,
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
        flops, nbytes = work(args, present, occ)
        bound_ms, bound_by = bound(flops, nbytes)
        results[name] = dict(max_abs_err=err, skipped_share=share, ms=ms, dense_ms=dense_ms,
                             force_all_ms=force_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
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


def attention_inputs(B, K, seed=0):
    """Seeded inputs of both masked-attention kernels on the device: qn
    normalized, raw k and v, mask logits with rows 0-3 masked everywhere (the
    guard), and base / pos / projections at E = 256 (pos the sine encoding of
    the image)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    qn = rn(B, H, Q, D)
    qn = qn / qn.norm(dim=-1, keepdim=True)
    logits = rn(B, Q, K)
    logits[:, :4] = -1.0 - logits[:, :4].abs()
    h = 480 if K == 480 * 640 else 224
    pos = position_embedding_sine(h, K // h, E // 2).reshape(K, E).contiguous()
    proj = [rn(B, K, E) * 0.3, pos, rn(E, E) * 0.06, rn(E) * 0.1, rn(E, E) * 0.06,
            rn(E) * 0.1]
    return qn, rn(B, H, K, D), rn(B, H, K, D), logits, proj


def masked_attention_phase():
    """10. both masked-attention kernels: driven once per shape (counted),
    held to their plain versions in fp64, timed. -> ({kernel: launches},
    {kernel: {shape: results}})."""
    cases = {"stage1_B1_K307200": (1, 480 * 640), "crops_B20_K50176": (20, 224 * 224)}
    kernels = (masked_hypersphere_attention, fused_masked_hypersphere_attention)
    launches = {fn.__name__: 0 for fn in kernels}
    results = {fn.__name__: {} for fn in kernels}
    for name, (B, K) in cases.items():
        qn, k, v, logits, proj = attention_inputs(B, K)
        row5 = lambda: masked_hypersphere_attention(qn, k, v, logits, k_normalized=False)
        row6 = lambda: fused_masked_hypersphere_attention(qn, *proj, logits)
        for fn in kernels:
            fn.launches = 0
        got5, got6 = row5(), row6()
        torch.cuda.synchronize()
        for fn in kernels:     # the driving calls; the timing below does not count
            launches[fn.__name__] += fn.launches
        d = lambda t: t.double()
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
        for kernel, got, want, fn, plain, flops, nbytes in (
                ("masked_hypersphere_attention", got5, want5, row5,
                 lambda: masked_hypersphere_attention_plain(qn, k, v, logits),
                 B * (2 * H * Q * K * D + 2 * H * Q * K * (D + 1)),
                 4 * (qn.numel() * 2 + k.numel() + v.numel() + logits.numel())),
                ("fused_masked_hypersphere_attention", got6, want6, row6,
                 lambda: fused_masked_hypersphere_attention_plain(qn, *proj, logits),
                 B * (2 * H * Q * K * D + 2 * H * Q * K * (D + 1) + 2 * 2 * K * E * E),
                 4 * (qn.numel() * 2 + logits.numel() + sum(t.numel() for t in proj)))):
            err = (got.double() - want).abs().max().item()
            finite = bool(torch.isfinite(got).all())
            ms = time_ms(fn)
            plain_ms = time_ms(plain, warmup=1, reps=3)
            library_ms = time_ms(sdpa) if kernel == "masked_hypersphere_attention" else None
            bound_ms, bound_by = bound(flops, nbytes)
            results[kernel][name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                         bound_ms=bound_ms, bound_by=bound_by,
                                         library_ms=library_ms)
            sync_print(f"masked_attention {kernel} {name}: max_abs_err={err:.3e} (vs the plain "
                       f"version in fp64, tol={TOL:.0e}) finite={finite} guard_rows={guard_rows} "
                       f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} bound_ms={bound_ms:.3f} "
                       f"({bound_by}; {flops / 1e9:.1f} GFLOP, {nbytes / 1e9:.3f} GB) "
                       f"achieved={flops / ms / 1e9:.2f} TFLOP/s"
                       + (f" library_ms={library_ms:.3f} (F.scaled_dot_product_attention on "
                          f"k normalized and the guard-corrected bias, both built outside the "
                          f"timed call; {lib_err:.2e} from fp64)" if library_ms is not None
                          else " library_ms=null (no one PyTorch call computes it)"))
            if not (err <= TOL and finite and guard_rows > 0):
                raise AssertionError(f"{kernel} disagrees with its plain version at {name}")
        del qn, k, v, logits, proj, got5, got6, want5, want6, kn, bias
        torch.cuda.empty_cache()
    for kernel, n in launches.items():
        if n != len(cases):
            raise AssertionError(f"{kernel} launched {n} times while driven {len(cases)} times")
    return launches, results


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
    """6. kernel, plain and bound ms of both kernels at both shapes."""
    for name, (X, first) in cases.items():
        B, N, _ = X.shape
        for kernel, fn, plain, climb in (
                ("fps_seeds", lambda: fps_seeds(X, first, SEEDS),
                 lambda: fps_seeds_plain(X, first, SEEDS), False),
                ("mean_shift_seeds", lambda: mean_shift_seeds(X, first, KAPPA, SEEDS, ITERS),
                 lambda: mean_shift_seeds_plain(X, first, KAPPA, SEEDS, ITERS), True)):
            ms = time_ms(fn, warmup=2, reps=5)
            plain_ms = time_ms(plain, warmup=1, reps=3)
            flops, nbytes = mean_shift_work(B, N, climb)
            t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
            bound_ms = max(t_ops, t_bytes) * 1e3
            bound_by = "operations" if t_ops >= t_bytes else "bytes"
            results[name][kernel] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                         bound_by=bound_by)
            sync_print(f"ucn_time {kernel} {name}: kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
                       f"bound_ms={bound_ms:.4f} ({bound_by}; {flops / 1e9:.2f} GFLOP, "
                       f"{nbytes / 1e9:.4f} GB) achieved={flops / ms / 1e9:.2f} TFLOP/s")
        # connected components: adjacency on the device, one copy to the
        # host, the sequential sweep in numpy, labels back (host clock)
        Z = mean_shift_seeds(X, first, KAPPA, SEEDS, ITERS)[0]
        cc_ms = median_ms(lambda: connected_components(Z, EPSILON), reps=5)[0]
        results[name]["connected_components_ms"] = cc_ms
        sync_print(f"ucn_time connected_components {name}: host_ms={cc_ms:.3f} "
                   f"(components {int(connected_components(Z, EPSILON).max(1).values.max()) + 1} "
                   "at most per image)")


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
        fps_seeds.launches = mean_shift_seeds.launches = fused_uoms_cross_attention.launches = 0
        s1 = pred.stage1(image, xyz)
        torch.cuda.synchronize()
        n1 = (fps_seeds.launches, mean_shift_seeds.launches)
        refined = pred.refine(s1)
        torch.cuda.synchronize()
        n2 = (fps_seeds.launches - n1[0], mean_shift_seeds.launches - n1[1])
        launches[path] = {"fps_seeds": fps_seeds.launches,
                          "mean_shift_seeds": mean_shift_seeds.launches}
        n_crops = int(sum(int(c.present.sum()) for c in s1.crops))
        crop_counts.add(n_crops)
        labels = s1.labels
        sync_print(f"ucn_main {path}: launches fps_seeds stage1={n1[0]} stage2={n2[0]}, "
                   f"mean_shift_seeds stage1={n1[1]} stage2={n2[1]}; present_crops={n_crops} "
                   f"stage1_clusters={int(s1.n_clusters[0])} "
                   f"refined_instances={int((refined.unique() >= 1).sum())}")
        assert fused_uoms_cross_attention.launches == 0
        assert n_crops >= 1, "stage 1 gave no crop, so stage 2 did not run"
        assert n1[0] == 1 and n2[0] == 1, "the seeding kernel did not run once per stage"
        assert n1[1] == n2[1] == (1 if use_pallas else 0), "climbing kernel launches"
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

    # 2. kernel vs plain at the main path's shapes
    t0 = time.perf_counter()
    shapes = {"stage1_B1_K307200": (1, 480, 640, ()),
              "crops_B8_K50176": (8, 224, 224, (3, 6)),
              "crops_B20_K50176": (20, 224, 224, ())}
    cases, results = {}, {}
    for name, s in shapes.items():
        args, present, err = check_case(name, *s)
        cases[name] = (args, present)
        results[name] = {"max_abs_err": err}
        torch.cuda.empty_cache()
    phase_done("check", t0)

    # 3. timing
    t0 = time.perf_counter()
    for name, (args, present) in cases.items():
        ms = time_ms(lambda: fused_uoms_cross_attention(*args, present=present))
        plain_ms = time_ms(lambda: fused_uoms_cross_attention_plain(*args, present=present))
        flops, nbytes = work(args, present)
        bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
        bound_by = "operations" if flops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        results[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                             gflop=flops / 1e9, gbytes=nbytes / 1e9)
        sync_print(f"time {name}: kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
                   f"bound_ms={bound_ms:.3f} ({bound_by}; {flops / 1e9:.1f} GFLOP, "
                   f"{nbytes / 1e9:.3f} GB) achieved={flops / ms / 1e9:.2f} TFLOP/s")
    del cases, args, present
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
    mattn_launches, mattn_results = masked_attention_phase()
    phase_done("masked_attention", t0)

    s1r = results["stage1_B1_K307200"]
    kernels = [{
        "name": "fused_uoms_cross_attention",
        "route": "cuda",
        "source": "unseenobjectswithmeanshift_torch/csrc/fused_cross_attention.cu",
        "replaces": "unseenobjectswithmeanshift_tpu/ops/fused_cross_attention.py:334",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in results.values()),
        "ms": s1r["ms"], "plain_ms": s1r["plain_ms"], "bound_ms": s1r["bound_ms"],
        "bound_by": s1r["bound_by"], "library_ms": None,
        "shapes": results,
    }]
    u1 = ucn_results["stage1_B1_N307200"]
    for name, line, err_key in (("fps_seeds", 242, "fps_max_gap"),
                                ("mean_shift_seeds", 127, "climb_max_abs_err")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "unseenobjectswithmeanshift_torch/csrc/"
                      + ("fps_seeds.cu" if name == "fps_seeds" else "mean_shift_climb.cu"),
            "replaces": f"unseenobjectswithmeanshift_tpu/ops/pallas_mean_shift.py:{line}",
            "launches": sum(p[name] for p in ucn_launches.values()),
            "launches_by_path": {p: v[name] for p, v in ucn_launches.items()},
            "max_abs_err": max(r[err_key] for r in ucn_results.values()),
            "max_abs_err_of": ("gap to the fp64 argmax of the running minimum distance"
                               if name == "fps_seeds" else "climbed seeds vs fp64"),
            **{k: u1[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
            "shapes": {k: {**{e: v for e, v in r.items() if not isinstance(v, dict)},
                           **r.get(name, {})} for k, r in ucn_results.items()},
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
            "replaces": f"unseenobjectswithmeanshift_tpu/ops/pallas_attention.py:{line}",
            "launches": mattn_launches[name],
            "launches_of": "driven directly by the masked_attention phase: no model calls it",
            "max_abs_err": max(x["max_abs_err"] for x in r.values()),
            **{k: r["stage1_B1_K307200"][k]
               for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "shapes": r,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
