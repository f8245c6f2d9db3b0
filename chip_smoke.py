#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

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

The line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Any failure ends the run with a
traceback and a non-zero exit code. Without CUDA the script fails at once.
"""

import json
import statistics
import subprocess
import sys
import time

import torch

from unseenobjectswithmeanshift_torch.config import get_config
from unseenobjectswithmeanshift_torch.models.position_encoding import position_embedding_sine
from unseenobjectswithmeanshift_torch.ops import _build
from unseenobjectswithmeanshift_torch.ops.fused_cross_attention import (
    fused_uoms_cross_attention, fused_uoms_cross_attention_plain,
)
from unseenobjectswithmeanshift_torch.ops.mean_shift import connected_components, seed_hill_climbing
from unseenobjectswithmeanshift_torch.ops.mean_shift_kernels import (
    fps_seeds, fps_seeds_plain, mean_shift_seeds, mean_shift_seeds_plain,
)
from unseenobjectswithmeanshift_torch.pipeline.factory import (
    build_two_stage_predictor, build_ucn_predictor,
)
from unseenobjectswithmeanshift_torch.utils.preprocess import compute_xyz

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


def work(args, present):
    """(fp32 operations, bytes) the function needs for these inputs: each input
    read once and the output written once; absent images need no work."""
    qn, featT = args[0], args[1]
    B, K = featT.shape[0], featT.shape[2]
    n = int(present.sum())
    flops = 2 * K * E * E + n * (4 * K * C * E + 2 * Q * K * CM + 2 * H * Q * K * D
                                 + 2 * H * Q * K * (D + 1))
    nbytes = sum(a.numel() * a.element_size() for a in args) + present.numel() + qn.numel() * 4
    return flops, nbytes


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
    starts = torch.equal(idx[:, 0], first.clamp(0, N - 1))
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


def main():
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
