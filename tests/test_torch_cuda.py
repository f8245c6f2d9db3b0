"""The port on a GPU: the CUDA kernels against their plain versions, and the
two-stage and UCN predictors on CUDA against the same predictors on the CPU.

Every test is marked ``cuda`` and skips without a CUDA device. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import copy

import numpy as np
import pytest
import torch

from unseenobjectswithmeanshift_torch.config import get_config
from unseenobjectswithmeanshift_torch.models.decoder import MeanShiftDecoder
from unseenobjectswithmeanshift_torch.models.position_encoding import (
    position_embedding_sine, position_embedding_sine_factors,
)
from unseenobjectswithmeanshift_torch.ops.fused_cross_attention import (
    expand_pos, fused_uoms_cross_attention, fused_uoms_cross_attention_plain, mask_pass,
    tile_occupancy, unmasked_keys,
)
from unseenobjectswithmeanshift_torch.weights import init_random
from unseenobjectswithmeanshift_torch.ops.mean_shift import first_row, seed_hill_climbing
from unseenobjectswithmeanshift_torch.ops.mean_shift_kernels import (
    device_limits, fps_plan, fps_seeds, fps_seeds_plain, mean_shift_seeds,
)
from unseenobjectswithmeanshift_torch.ops import pallas_attention
from unseenobjectswithmeanshift_torch.ops.pallas_attention import (
    fused_masked_hypersphere_attention, fused_masked_hypersphere_attention_plain,
    masked_hypersphere_attention, masked_hypersphere_attention_plain,
)
from chip_smoke import (
    CLIMB_TOL, FPS_TOL, decisive_predictor, decisive_ucn_predictor, mask_mismatches,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_inputs(seed, B, Q, K, H=8, D=32, C=64, Cm=256):
    """Seeded inputs; mask logits exact in fp32 (integers times 1/4), queries 0
    and 3 masked everywhere (the guard)."""
    rng = np.random.RandomState(seed)
    E = H * D
    f32 = np.float32
    qn = rng.randn(B, H, Q, D).astype(f32)
    qn /= np.linalg.norm(qn, axis=-1, keepdims=True)
    mf = (np.round(rng.randn(B, Cm, K) * 2) / 4).astype(f32)
    mf[:, 0] = np.abs(mf[:, 0]) + 0.25
    me = np.round(rng.randn(B, Q, Cm) * 3).astype(f32)
    me[:, [0, 3]] = 0.0
    me[:, [0, 3], 0] = -5.0
    return [qn, rng.randn(B, C, K).astype(f32) * 0.3, mf, me,
            rng.randn(E, K).astype(f32) * 0.3, rng.randn(C, E).astype(f32) * 0.2,
            rng.randn(C, E).astype(f32) * 0.2, rng.randn(E, E).astype(f32) * 0.1,
            rng.randn(E).astype(f32) * 0.1, rng.randn(E).astype(f32) * 0.1]


@pytest.mark.parametrize("B,Q,K,present", [(1, 100, 4096, None), (3, 16, 1000, [1, 0, 1]),
                                           (2, 100, 777, [0, 1]), (2, 128, 64, None),
                                           (1, 37, 3000, None),
                                           (20, 100, 1536, [i % 7 != 3 for i in range(20)])])
def test_kernel_matches_plain(cuda, B, Q, K, present):
    # full-width heads; K not a multiple of the 64-key tile; absent images
    args = [torch.from_numpy(a).to(cuda) for a in make_inputs(0, B, Q, K)]
    p = None if present is None else torch.tensor(present, dtype=torch.bool, device=cuda)
    before = fused_uoms_cross_attention.launches
    got = fused_uoms_cross_attention(*args, present=p)
    torch.cuda.synchronize()
    assert fused_uoms_cross_attention.launches == before + 1
    want = fused_uoms_cross_attention_plain(*[a.double() for a in args], present=p)
    # against the plain version in fp64: the kernel's error (fp32 data,
    # products in 3xTF32) is 2e-6 to 5e-6 (measured at K = 307,200 and 50,176
    # by chip_smoke.py); masks are exact on both sides
    np.testing.assert_allclose(got.double().cpu().numpy(), want.cpu().numpy(), atol=1e-5)
    if present is not None:
        for b, on in enumerate(present):
            assert on or bool((got[b] == 0).all())


def test_kernel_is_deterministic(cuda):
    args = [torch.from_numpy(a).to(cuda) for a in make_inputs(1, 2, 100, 5000)]
    assert torch.equal(fused_uoms_cross_attention(*args), fused_uoms_cross_attention(*args))


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args = [torch.from_numpy(a).to(cuda) for a in make_inputs(2, 1, 8, 128)]
    with pytest.raises(TypeError):
        fused_uoms_cross_attention(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        fused_uoms_cross_attention(args[0], args[1].transpose(1, 2).contiguous().transpose(1, 2),
                                   *args[2:])
    with pytest.raises(ValueError):      # head width 16: the kernel takes 32
        qn = args[0].reshape(1, 16, 8, 16).contiguous()
        fused_uoms_cross_attention(qn, *args[1:])
    with pytest.raises(ValueError):
        fused_uoms_cross_attention(args[0], args[1].cpu(), *args[2:])


def test_two_stage_on_cuda_matches_cpu(cuda):
    cfg = get_config()
    d = cfg.decoder
    d.hidden_dim, d.nheads, d.num_queries, d.dec_layers = 128, 4, 16, 3
    d.dim_feedforward, d.mask_dim = 128, 48
    cfg.pixel_decoder.mask_dim = 48
    cfg.test.max_instances, cfg.test.crop_size = 5, 32
    preds = [decisive_predictor(seed=4, device=device, cfg=copy.deepcopy(cfg),
                                cfg_crop=copy.deepcopy(cfg)) for device in ("cpu", cuda)]
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.rand(1, 64, 64, 3).astype(np.float32) - 0.4)
    xyz = torch.from_numpy((rng.rand(1, 64, 64, 3) * 1.5).astype(np.float32))
    cpu_l, cpu_r = preds[0](img, xyz)
    before = fused_uoms_cross_attention.launches
    s1 = preds[1].stage1(img.to(cuda), xyz.to(cuda))
    assert fused_uoms_cross_attention.launches == before + 3
    gpu_r = preds[1].refine(s1)
    assert fused_uoms_cross_attention.launches == before + 6
    assert len(torch.unique(cpu_l)) >= 2
    np.testing.assert_array_equal(s1.labels.cpu().numpy(), cpu_l.numpy())
    np.testing.assert_array_equal(gpu_r.cpu().numpy(), cpu_r.numpy())


def clustered(seed, B, N, k=6, d=64):
    """[B, N, d] unit rows around k directions (the per-dimension noise
    scaled as in chip_smoke.clustered_unit_vectors), 1% copied rows, and 4
    isolated directions at 3 positions each (exact ties the farthest-point
    chain reaches). -> (X, groups [4, 3] sorted positions)."""
    rng = np.random.RandomState(seed)
    c = rng.randn(B, k, d)
    c /= np.linalg.norm(c, axis=-1, keepdims=True)
    X = c[np.arange(B)[:, None], rng.randint(0, k, (B, N))] + (
        0.06 * np.sqrt(64 / d) * rng.randn(B, N, d))
    X[:, rng.randint(0, N, N // 100)] = X[:, rng.randint(0, N, N // 100)]
    groups = np.sort(rng.choice(N, 12, replace=False).reshape(4, 3), axis=1)
    X[:, groups.reshape(-1)] = np.repeat(rng.randn(B, 4, d), 3, axis=1)
    X /= np.linalg.norm(X, axis=-1, keepdims=True)
    return X.astype(np.float32), groups


def fps_gaps(X, idx):
    """Per step, fp64 max of the running minimum distance (from the chain's
    own earlier seeds) minus its value at the chosen index: [B, S-1]."""
    X64, rows = X.double(), torch.arange(X.shape[0], device=X.device)
    idx, mind, gaps = idx.long(), None, []
    for i in range(idx.shape[1]):
        if i:
            gaps.append(mind.amax(1) - mind[rows, idx[:, i]])
        d = 0.5 * (1 - torch.bmm(X64, X64[rows, idx[:, i]][:, :, None])[..., 0])
        mind = d if mind is None else torch.minimum(mind, d)
    return torch.stack(gaps, 1)


@pytest.mark.parametrize("B,N,S", [(1, 4099, 100), (3, 1000, 37), (2, 50_177, 20)])
def test_fps_kernel_attains_the_fp64_argmax(cuda, B, N, S):
    # B > 1 with a first index per image; N ragged for every block size
    X_np, groups = clustered(B + N, B, N)
    X = torch.from_numpy(X_np).to(cuda)
    first = torch.tensor([0, N - 1, 17][:B], dtype=torch.int32, device=cuda)
    before = fps_seeds.launches
    seeds, idx = fps_seeds(X, first, S)
    torch.cuda.synchronize()
    assert fps_seeds.launches == before + 1
    assert idx.dtype == torch.int32 and torch.equal(idx[:, 0], first)
    rows = torch.arange(B, device=cuda)[:, None]
    assert torch.equal(seeds, X[rows, idx.long()])               # copied rows, bit for bit
    assert float(fps_gaps(X, idx).max()) <= FPS_TOL
    chosen = idx.cpu().numpy()
    for b in range(B):                                            # copies: lowest index first
        for g in groups:
            hit = [list(chosen[b]).index(p) if p in chosen[b] else S for p in g]
            assert min(hit[1:]) >= hit[0]


def test_fps_kernel_ties_go_to_the_lowest_index(cuda):
    N, S = 1000, 8
    X = np.zeros((2, N, 64), np.float32)
    X[..., 0] = 1.0
    X[:, [300, 7, 50], 0] = -1.0          # three copies of the farthest row
    X[:, [9, 5], :] = 0.0
    X[:, [9, 5], 1] = 1.0                 # two copies of the next
    X[1] = X[1, ::-1]                     # the second image mirrored
    X = torch.from_numpy(np.ascontiguousarray(X)).to(cuda)
    first = torch.tensor([0, 3], dtype=torch.int32, device=cuda)
    _, idx = fps_seeds(X, first, S)
    _, want = fps_seeds_plain(X, first, S)
    # every distance is exact (0, 0.5 or 1): after the two groups all are 0,
    # so the argmax takes index 0
    assert idx[0].tolist() == [0, 7, 5, 0, 0, 0, 0, 0]
    assert idx[1].tolist() == [3, N - 301, N - 10, 0, 0, 0, 0, 0]
    assert torch.equal(idx, want)


@pytest.mark.parametrize("B,N,S", [(1, 4099, 100), (3, 1000, 37)])
def test_climb_kernel_matches_plain_in_fp64(cuda, B, N, S):
    X = torch.from_numpy(clustered(7 * B, B, N)[0]).to(cuda)
    first = torch.tensor([5, 0, N - 1][:B], dtype=torch.int32, device=cuda)
    seeds, idx = fps_seeds(X, first, S)
    before = mean_shift_seeds.launches
    Z, zidx = mean_shift_seeds(X, first, 20.0, S, 10)
    torch.cuda.synchronize()
    assert mean_shift_seeds.launches == before + 1
    assert torch.equal(zidx, idx)
    want = seed_hill_climbing(X.double(), seeds.double(), 20.0, 10)
    # chip_smoke.py measures ~2e-6 at 307,200 keys; CLIMB_TOL is 2e-5
    np.testing.assert_allclose(Z.double().cpu().numpy(), want.cpu().numpy(), atol=CLIMB_TOL)


def test_mean_shift_kernels_are_deterministic(cuda):
    X = torch.from_numpy(clustered(3, 2, 5000)[0]).to(cuda)
    assert all(torch.equal(a, b) for a, b in zip(fps_seeds(X, 11, 50), fps_seeds(X, 11, 50)))
    assert all(torch.equal(a, b) for a, b in zip(mean_shift_seeds(X, 11, 20.0, 50, 10),
                                                 mean_shift_seeds(X, 11, 20.0, 50, 10)))


def test_mean_shift_wrappers_reject_what_the_kernels_do_not_take(cuda):
    X = torch.from_numpy(clustered(4, 2, 300)[0]).to(cuda)
    with pytest.raises(TypeError):
        fps_seeds(X.double(), 0, 10)
    with pytest.raises(ValueError):                       # width 32: the kernels take 64, 128
        fps_seeds(X[..., :32].contiguous(), 0, 10)
    with pytest.raises(ValueError):
        mean_shift_seeds(X.transpose(0, 1).contiguous().transpose(0, 1), 0, 20.0, 10, 2)
    with pytest.raises(ValueError):                       # first index on another device
        fps_seeds(X, torch.zeros(2, dtype=torch.int32), 10)
    with pytest.raises(TypeError):
        fps_seeds(X, torch.zeros(2, device=cuda), 10)
    with pytest.raises(ValueError):                       # a warpgroup per 64 seeds, 2 at most
        mean_shift_seeds(X, 0, 20.0, 129, 2)


def tabletop_scene(seed, h=64, w=64):
    """Four boxes of distinct colour on a tilted plane, 5% depth holes:
    ([1, h, w, 3] image, [1, h, w, 3] XYZ) as numpy fp32."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    depth = 0.9 + 0.4 * ys / h
    img = rng.rand(h, w, 3).astype(np.float32) * 0.2 - 0.1
    colours = [[0.6, -0.6, 0.3], [-0.6, 0.4, 0.6], [0.5, 0.5, -0.6], [-0.4, -0.5, -0.5]]
    for i, c in enumerate(colours):
        box = (ys >= 6 + 13 * i) & (ys < 22 + 13 * i) & (xs >= 4 + 14 * i) & (xs < 18 + 14 * i)
        depth = np.where(box, depth - 0.15 - 0.05 * i, depth)
        img[box] += np.array(c, np.float32)
    depth = np.where(rng.rand(h, w) < 0.05, 0.0, depth)
    xyz = np.stack([(xs - w / 2) * depth / 60.0, (ys - h / 2) * depth / 60.0, depth], -1)
    return img[None], xyz[None].astype(np.float32)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ucn_on_cuda_matches_cpu(cuda, use_pallas):
    cfg = get_config()
    cfg.mean_shift.num_seeds, cfg.mean_shift.use_pallas = 12, use_pallas
    cfg.test.max_instances, cfg.test.crop_size = 4, 32
    img, xyz = map(torch.from_numpy, tabletop_scene(1))
    preds = [decisive_ucn_predictor(img.to(device), xyz.to(device), seed=1, device=device,
                                    cfg=copy.deepcopy(cfg), cfg_crop=copy.deepcopy(cfg))
             for device in ("cpu", cuda)]
    cpu_l, cpu_r = preds[0](img, xyz)
    before = (fps_seeds.launches, mean_shift_seeds.launches)
    s1 = preds[1].stage1(img.to(cuda), xyz.to(cuda))
    gpu_r = preds[1].refine(s1)
    climb = 2 if use_pallas else 0
    assert (fps_seeds.launches, mean_shift_seeds.launches) == (before[0] + 2, before[1] + climb)
    assert len(torch.unique(cpu_l)) >= 8 and int(s1.crops[0].present.sum()) >= 1
    np.testing.assert_array_equal(s1.labels.cpu().numpy(), cpu_l.numpy())
    np.testing.assert_array_equal(gpu_r.cpu().numpy(), cpu_r.numpy())


def concentrate(args, window, guard_images=()):
    """Only keys in [window) unmasked, for every query; the images in
    guard_images keep their guard queries 0 and 3 (masked everywhere, so that
    image keeps every tile). Logits stay exact: integers times 1/4."""
    mf, me = args[2].copy(), args[3].copy()
    guard = me[:, [0, 3]].copy()
    mf[:, 1] = 4.0
    mf[:, 1, window[0]:window[1]] = -4.0
    me = np.round(me * 0.1)
    me[:, :, 1] = -8.0
    for b in guard_images:
        me[b, [0, 3]] = guard[b]
    return args[:2] + [mf, me] + args[4:]


@pytest.mark.parametrize("B,Q,K,present,window,guard_images", [
    (1, 100, 4096, None, None, ()), (3, 100, 5000, [1, 0, 1], (1000, 1300), (0,)),
    (2, 100, 4097, [0, 1], (4000, 4097), ()), (4, 16, 3000, [1, 1, 0, 1], (0, 70), (3,))])
def test_tile_skip_kernel_equals_dense_kernel(cuda, B, Q, K, present, window, guard_images):
    args = make_inputs(5, B, Q, K)
    if window is not None:
        args = concentrate(args, window, guard_images)
    args = [torch.from_numpy(a).to(cuda) for a in args]
    p = None if present is None else torch.tensor(present, dtype=torch.bool, device=cuda)
    dense = fused_uoms_cross_attention(*args, present=p)
    before = fused_uoms_cross_attention.launches
    skip = fused_uoms_cross_attention(*args, present=p, tile_skip=True)
    force = fused_uoms_cross_attention(*args, present=p, tile_skip=True, tile_skip_force_all=True)
    torch.cuda.synchronize()
    assert fused_uoms_cross_attention.launches == before + 2
    assert torch.equal(skip, dense) and torch.equal(force, dense)
    want = fused_uoms_cross_attention_plain(*[a.double() for a in args], present=p,
                                            tile_skip=True)
    np.testing.assert_allclose(skip.double().cpu().numpy(), want.cpu().numpy(), atol=1e-5)
    if window is not None:              # the inputs do leave tiles to skip
        occ = tile_occupancy(unmasked_keys(args[3] @ args[2]), p)
        kept = [b for b in range(B) if (present is None or present[b]) and b not in guard_images]
        assert kept and not occ[kept].all()


@pytest.mark.parametrize("B,Q,h,w,present", [(1, 100, 48, 64, None), (3, 37, 30, 31, [1, 0, 1]),
                                             (2, 128, 17, 23, None)])
def test_separable_pos_matches_general_pos(cuda, B, Q, h, w, present):
    # the decoder's input form (sine factors, h + w projected rows) against the
    # general form on the same sine encoding, and both against fp64
    args = [torch.from_numpy(a).to(cuda) for a in make_inputs(7, B, Q, h * w)]
    factors = position_embedding_sine_factors(h, w, 128, device=cuda)
    posT = position_embedding_sine(h, w, 128, device=cuda).reshape(h * w, 256).T.contiguous()
    assert torch.equal(expand_pos(factors), posT)
    p = None if present is None else torch.tensor(present, dtype=torch.bool, device=cuda)
    before = (fused_uoms_cross_attention.launches, fused_uoms_cross_attention.general_pos_launches)
    sep = fused_uoms_cross_attention(*args[:4], factors, *args[5:], present=p)
    gen = fused_uoms_cross_attention(*args[:4], posT, *args[5:], present=p)
    skip = fused_uoms_cross_attention(*args[:4], factors, *args[5:], present=p, tile_skip=True)
    torch.cuda.synchronize()
    assert (fused_uoms_cross_attention.launches,
            fused_uoms_cross_attention.general_pos_launches) == (before[0] + 3, before[1] + 1)
    assert torch.equal(skip, sep)
    np.testing.assert_allclose(sep.cpu().numpy(), gen.cpu().numpy(), atol=1e-5)
    want = fused_uoms_cross_attention_plain(*[a.double() for a in args[:4]], posT.double(),
                                            *[a.double() for a in args[5:]], present=p)
    np.testing.assert_allclose(sep.double().cpu().numpy(), want.cpu().numpy(), atol=1e-5)


@pytest.mark.parametrize("B,Q,K,present", [(1, 100, 4096, None), (3, 37, 777, [1, 0, 1]),
                                           (2, 128, 5000, None), (1, 16, 33, None)])
def test_mask_pass_matches_fp64_signs(cuda, B, Q, K, present):
    # random fp32 mask features and embeds, whose TF32 low parts are nonzero:
    # every bit takes the sign of the fp64 logit outside chip_smoke's
    # MASK_MARGIN of its scale (plain 1xTF32 misses it; see
    # tests/test_torch_tf32_split.py), every count equals its bits
    rng = np.random.RandomState(3)
    me = torch.from_numpy(rng.randn(B, Q, 256).astype(np.float32)).to(cuda)
    mfT = torch.from_numpy((rng.randn(B, 256, K) * 0.5).astype(np.float32)).to(cuda)
    p = None if present is None else torch.tensor(present, dtype=torch.bool, device=cuda)
    before = mask_pass.launches
    bits, cnt = mask_pass(me, mfT, p)
    torch.cuda.synchronize()
    assert mask_pass.launches == before + 1
    r = mask_mismatches(bits, cnt, me, mfT, p)
    assert r["bad"] == 0 and r["cnt_ok"], r
    for b in range(B):
        if present is not None and not present[b]:
            assert (bits[b] == 0).all() and (cnt[b] == 0).all()


def test_decoder_runs_no_general_pos_projection(cuda):
    dec = init_random(MeanShiftDecoder(hidden_dim=256, num_queries=100, nheads=8,
                                       dim_feedforward=256, dec_layers=2, mask_dim=256,
                                       in_channels=64), torch.Generator().manual_seed(0))
    dec = dec.to(cuda).eval()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 24, 40, 64).astype(np.float32)).to(cuda)
    mf = torch.from_numpy(rng.randn(2, 24, 40, 256).astype(np.float32)).to(cuda)
    before = (fused_uoms_cross_attention.launches, fused_uoms_cross_attention.general_pos_launches)
    with torch.no_grad():
        out = dec(x, mf)
    torch.cuda.synchronize()
    assert fused_uoms_cross_attention.launches == before[0] + 2
    assert fused_uoms_cross_attention.general_pos_launches == before[1]
    assert torch.isfinite(out["pred_logits"]).all()


def mha_inputs(seed, B, Q, K, H=8, D=32, guard=True):
    rng = np.random.RandomState(seed)
    qn = rng.randn(B, H, Q, D).astype(np.float32)
    qn /= np.linalg.norm(qn, axis=-1, keepdims=True)
    logits = rng.randn(B, Q, K).astype(np.float32)
    rows = [r for r in (0, 3) if r < Q]
    if guard:
        logits[:, rows] = -1.0 - np.abs(logits[:, rows])
    return qn, rng.randn(B, H, K, D).astype(np.float32), \
        rng.randn(B, H, K, D).astype(np.float32), logits


def fused_args(seed, B, Q, K, E, H=8, D=32):
    """qn, base, pos, wk, bk, wv, bv, logits for the fused kernel."""
    rng = np.random.RandomState(seed)
    qn, _, _, logits = mha_inputs(seed, B, Q, K, H, D)
    f32 = np.float32
    return [qn, rng.randn(B, K, E).astype(f32) * 0.3, rng.randn(K, E).astype(f32) * 0.3,
            rng.randn(E, H * D).astype(f32) * 0.1, rng.randn(H * D).astype(f32) * 0.1,
            rng.randn(E, H * D).astype(f32) * 0.1, rng.randn(H * D).astype(f32) * 0.1, logits]


def assert_masked_attention_matches_plain(cuda, qn, k, v, logits, kv_transposed=False):
    args = [torch.from_numpy(a).to(cuda) if isinstance(a, np.ndarray) else a
            for a in (qn, k, v, logits)]
    before = masked_hypersphere_attention.launches
    got = masked_hypersphere_attention(*args, kv_transposed=kv_transposed, k_normalized=False)
    torch.cuda.synchronize()
    assert masked_hypersphere_attention.launches == before + 1
    want = masked_hypersphere_attention_plain(*[a.double() for a in args],
                                              kv_transposed=kv_transposed)
    # chip_smoke.py holds the kernel at 2e-5 from fp64 at K = 307,200
    np.testing.assert_allclose(got.double().cpu().numpy(), want.cpu().numpy(), atol=2e-5)


def assert_fused_matches_plain(cuda, arrays):
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    before = fused_masked_hypersphere_attention.launches
    got = fused_masked_hypersphere_attention(*args)
    torch.cuda.synchronize()
    assert fused_masked_hypersphere_attention.launches == before + 1
    want = fused_masked_hypersphere_attention_plain(*[a.double() for a in args])
    np.testing.assert_allclose(got.double().cpu().numpy(), want.cpu().numpy(), atol=2e-5)


@pytest.mark.parametrize("B,Q,K,kv_transposed", [(1, 100, 4096, False), (3, 17, 1000, True),
                                                 (2, 128, 777, False), (2, 100, 70, True),
                                                 (1, 1, 50, False), (2, 128, 63, True)])
def test_masked_attention_kernel_matches_plain(cuda, B, Q, K, kv_transposed):
    qn, k, v, logits = mha_inputs(B + K, B, Q, K)
    if kv_transposed:   # K % 4 != 0 takes the kernel's 4-byte copies
        k, v = k.transpose(0, 1, 3, 2).copy(), v.transpose(0, 1, 3, 2).copy()
    assert_masked_attention_matches_plain(cuda, qn, k, v, logits, kv_transposed)


@pytest.mark.parametrize("kv_transposed", [False, True])
def test_masked_attention_kernel_takes_unaligned_rows(cuda, kv_transposed):
    # k and v 4 bytes past a 16-byte boundary: the kernel's 4-byte copies
    qn, k, v, logits = mha_inputs(5, 2, 40, 300)
    if kv_transposed:
        k, v = k.transpose(0, 1, 3, 2).copy(), v.transpose(0, 1, 3, 2).copy()
    shifted = []
    for a in (k, v):
        t = torch.empty(a.size + 1, device=cuda)[1:].view(a.shape)
        t.copy_(torch.from_numpy(a))
        assert t.is_contiguous() and t.data_ptr() % 16 == 4
        shifted.append(t)
    assert_masked_attention_matches_plain(cuda, qn, *shifted, logits, kv_transposed)


@pytest.mark.parametrize("B,Q,K,E", [(1, 100, 4096, 256), (2, 16, 777, 96),
                                     (2, 128, 777, 20), (1, 1, 500, 13), (3, 100, 50, 256),
                                     (1, 100, 1000, 300), (2, 64, 129, 257)])
def test_fused_masked_attention_kernel_matches_plain(cuda, B, Q, K, E):
    # E = 13, 257: 4-byte copies and a zero-filled last stage; E = 300, 257:
    # wider than the 256 channels kept on chip, the weights stream
    assert_fused_matches_plain(cuda, fused_args(K, B, Q, K, E))


def test_masked_attention_kernels_take_any_head_count(cuda):
    qn, k, v, logits = mha_inputs(3, 2, 30, 500, H=3)
    assert_masked_attention_matches_plain(cuda, qn, k, v, logits)
    assert_fused_matches_plain(cuda, fused_args(3, 2, 30, 500, 64, H=3))


def test_masked_attention_kernels_are_deterministic(cuda):
    qn, k, v, logits = [torch.from_numpy(a).to(cuda) for a in mha_inputs(11, 4, 100, 20_000)]
    first = masked_hypersphere_attention(qn, k, v, logits)
    assert torch.equal(first, masked_hypersphere_attention(qn, k, v, logits))
    args = [torch.from_numpy(a).to(cuda) for a in fused_args(11, 4, 100, 20_000, 256)]
    first = fused_masked_hypersphere_attention(*args)
    assert torch.equal(first, fused_masked_hypersphere_attention(*args))


@pytest.mark.parametrize("E", [1, 20, 96, 256, 257, 1000])
def test_masked_attention_shared_memory_as_planned(cuda, E):
    # the wrapper's mirror of the kernels' shared memory equals the .cu's
    lib = pallas_attention._library()
    assert lib.uoms_mattn_smem_bytes(0, 0) == pallas_attention.smem_bytes(False)
    assert lib.uoms_mattn_smem_bytes(1, E) == pallas_attention.smem_bytes(True, E)


def test_masked_attention_wrappers_reject_what_the_kernels_do_not_take(cuda):
    qn, k, v, logits = [torch.from_numpy(a).to(cuda) for a in mha_inputs(0, 1, 8, 64)]
    with pytest.raises(ValueError):                       # head width 16
        masked_hypersphere_attention(qn.reshape(1, 16, 8, 16).contiguous(),
                                     k.reshape(1, 16, 64, 16).contiguous(),
                                     v.reshape(1, 16, 64, 16).contiguous(), logits)
    with pytest.raises(ValueError):                       # Q = 129 > 128
        masked_hypersphere_attention(*[torch.from_numpy(a).to(cuda)
                                       for a in mha_inputs(0, 1, 129, 64)])
    with pytest.raises(TypeError):
        masked_hypersphere_attention(qn, k.double(), v, logits)
    with pytest.raises(ValueError):                       # layout the flag does not say
        masked_hypersphere_attention(qn, k, v, logits, kv_transposed=True)
    with pytest.raises(ValueError):                       # not contiguous
        masked_hypersphere_attention(qn, k.transpose(2, 3), v.transpose(2, 3), logits,
                                     kv_transposed=True)
    with pytest.raises(ValueError):
        fused_masked_hypersphere_attention(qn, torch.zeros(1, 64, 256, device=cuda),
                                           torch.zeros(64, 256, device=cuda),
                                           torch.zeros(256, 128, device=cuda),
                                           torch.zeros(256, device=cuda),
                                           torch.zeros(256, 256, device=cuda),
                                           torch.zeros(256, device=cuda), logits)
    with pytest.raises(ValueError):                       # base on the CPU
        fused_masked_hypersphere_attention(qn, torch.zeros(1, 64, 256),
                                           torch.zeros(64, 256, device=cuda),
                                           torch.zeros(256, 256, device=cuda),
                                           torch.zeros(256, device=cuda),
                                           torch.zeros(256, 256, device=cuda),
                                           torch.zeros(256, device=cuda), logits)


@pytest.mark.parametrize("first", [-1, -2, 1000, 1020, -1020])
def test_fps_kernel_first_index_outside_the_rows(cuda, first):
    # jnp indexing of X[first]: -N <= i < 0 wraps, beyond the ends clamps;
    # indices[:, 0] is first as given
    X = torch.from_numpy(clustered(9, 2, 1000)[0]).to(cuda)
    seeds, idx = fps_seeds(X, first, 12)
    want_s, want_i = fps_seeds_plain(X, first, 12)
    assert torch.equal(idx, want_i) and torch.equal(seeds, want_s)
    assert idx[:, 0].tolist() == [first, first]
    row = {-1: 999, -2: 998, 1000: 999, 1020: 999, -1020: 0}[first]
    assert torch.equal(seeds[:, 0], X[:, row])


def test_two_stage_tile_skip_on_cuda_matches_dense(cuda):
    cfg = get_config()
    d = cfg.decoder
    d.hidden_dim, d.nheads, d.num_queries, d.dec_layers = 128, 4, 16, 3
    d.dim_feedforward, d.mask_dim = 128, 48
    cfg.pixel_decoder.mask_dim = 48
    cfg.test.max_instances, cfg.test.crop_size = 5, 32
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.rand(1, 64, 64, 3).astype(np.float32) - 0.4).to(cuda)
    xyz = torch.from_numpy((rng.rand(1, 64, 64, 3) * 1.5).astype(np.float32)).to(cuda)
    out = []
    for tile_skip in (False, True):
        pred = decisive_predictor(seed=4, device=cuda, cfg=copy.deepcopy(cfg),
                                  cfg_crop=copy.deepcopy(cfg), tile_skip=tile_skip)
        with torch.inference_mode():
            net = pred.model(img, xyz, light=True)
        out.append((net["pred_logits"], net["mask_embed"], *pred(img, xyz)))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def unit_rows(seed, B, N, d=64):
    """[B, N, 64] random unit rows; 1% of the rows (at least one, N > 1)
    copy another row: exact ties."""
    rng = np.random.RandomState(seed)
    X = rng.randn(B, N, d)
    if N > 1:
        n = max(1, N // 100)
        X[:, rng.randint(0, N, n)] = X[:, rng.randint(0, N, n)]
    return (X / np.linalg.norm(X, axis=-1, keepdims=True)).astype(np.float32)


def first_occurrences(X):
    """[B, N] index of the first row bit-equal to each row."""
    out = []
    for xb in X.cpu().numpy():
        _, first, inverse = np.unique(xb.view(np.uint32), axis=0, return_index=True,
                                      return_inverse=True)
        out.append(first[inverse.reshape(-1)])
    return np.stack(out)


@pytest.mark.parametrize("B,N,S,first", [
    (1, 50, 20, [3]),                         # N below the grid: one row a block
    (64, 1, 5, [0] * 32 + [-1] * 32),         # N = 1
    (3, 2000, 1, [5, -1, 2500]),              # S = 1: the first seed only
    (2, 3000, 128, [0, 2999]),                # S = 128
    (20, 5003, 30, list(range(0, 100, 5))),   # slices cross image boundaries
    (3, 150_001, 40, [7, -3, 150_000]),       # rows in shared memory, registers, L2, device memory
    (1, 307_200, 12, [400_000]),              # stage 1, first beyond the end
])
def test_fps_persistent_kernel_cases(cuda, B, N, S, first):
    X = torch.from_numpy(unit_rows(B * N + S, B, N)).to(cuda)
    first = torch.tensor(first, dtype=torch.int32, device=cuda)
    plan = fps_plan(B, N, **device_limits(cuda))
    if N == 150_001:       # the case reaches every kind of row
        assert plan["register_rows"] > 0 and plan["l2_held_rows"] > 0
        assert plan["streamed_rows"] > 0
    before = fps_seeds.launches
    seeds, idx = fps_seeds(X, first, S)
    torch.cuda.synchronize()
    assert fps_seeds.launches == before + 1                       # one launch a call
    assert idx.shape == (B, S) and torch.equal(idx[:, 0], first)  # as given
    rows = idx.long()
    rows[:, 0] = first_row(rows[:, 0], N)
    b = torch.arange(B, device=cuda)[:, None]
    assert torch.equal(seeds, X[b, rows])                         # copied rows, bit for bit
    if S > 1:
        assert float(fps_gaps(X, rows).max()) <= FPS_TOL
        # copies of one row have equal distances: the lowest index goes first
        chosen = rows[:, 1:].cpu().numpy()
        assert (np.take_along_axis(first_occurrences(X), chosen, 1) == chosen).all()
    again = fps_seeds(X, first, S)
    assert torch.equal(again[0], seeds) and torch.equal(again[1], idx)


@pytest.mark.parametrize("B,N,S", [(1, 4099, 1), (2, 3001, 37), (1, 50_177, 100),
                                   (1, 2000, 128), (20, 5003, 100)])
@pytest.mark.parametrize("rows", ["clustered", "random"])
def test_climb_tensor_core_kernel_cases(cuda, B, N, S, rows):
    # N not a multiple of the 64-key tile; random rows make the TF32
    # rounding of X visible (tests/test_torch_climb_tf32.py)
    X_np = clustered(3 * B + S, B, N)[0] if rows == "clustered" else unit_rows(S, B, N)
    X = torch.from_numpy(X_np).to(cuda)
    first = torch.arange(B, dtype=torch.int32, device=cuda) * 7
    seeds, idx = fps_seeds(X, first, S)
    before = mean_shift_seeds.launches
    Z, zidx = mean_shift_seeds(X, first, 20.0, S, 10)
    torch.cuda.synchronize()
    assert mean_shift_seeds.launches == before + 1
    assert torch.equal(zidx, idx) and bool(torch.isfinite(Z).all())
    want = seed_hill_climbing(X.double(), seeds.double(), 20.0, 10)
    np.testing.assert_allclose(Z.double().cpu().numpy(), want.cpu().numpy(), atol=CLIMB_TOL)
    assert torch.equal(mean_shift_seeds(X, first, 20.0, S, 10)[0], Z)


# The UCN-family configurations and the serving entry points.

@pytest.mark.parametrize("B,N,S", [(1, 4099, 100), (3, 1000, 37)])
def test_d128_kernels_match_fp64(cuda, B, N, S):
    """FPS and climbing at the 'cat' embedding's d = 128 (64 and 128 take
    the same gates; other widths raise)."""
    X = torch.from_numpy(clustered(11 * B, B, N, d=128)[0]).to(cuda)
    first = torch.tensor([5, 0, N - 1][:B], dtype=torch.int32, device=cuda)
    seeds, idx = fps_seeds(X, first, S)
    rows = torch.arange(B, device=cuda)[:, None]
    assert torch.equal(seeds, X[rows, idx.long()])
    assert float(fps_gaps(X, idx).max()) <= FPS_TOL
    Z, zidx = mean_shift_seeds(X, first, 20.0, S, 10)
    assert torch.equal(zidx, idx)
    want = seed_hill_climbing(X.double(), seeds.double(), 20.0, 10)
    np.testing.assert_allclose(Z.double().cpu().numpy(), want.cpu().numpy(), atol=CLIMB_TOL)
    with pytest.raises(ValueError):
        fps_seeds(torch.zeros(1, 100, 96, device=cuda), 0, 10)


@pytest.mark.parametrize("B,S", [(1, 100), (20, 100), (3, 1), (2, 128)])
def test_connected_components_kernel_equals_the_sweep(cuda, B, S):
    from unseenobjectswithmeanshift_torch.ops.mean_shift import (
        connected_components_plain, connected_components_sweep, seed_adjacency,
    )

    X = torch.from_numpy(clustered(B + S, B, 3000)[0]).to(cuda)
    Z = mean_shift_seeds(X, 0, 20.0, S, 10)[0]
    within = seed_adjacency(Z, 0.04)
    before = connected_components_sweep.launches
    got = connected_components_sweep(within)
    assert connected_components_sweep.launches == before + 1
    assert torch.equal(got.cpu(), connected_components_plain(within).cpu())
    with pytest.raises(ValueError):
        connected_components_sweep(torch.ones(1, 129, 129, dtype=torch.uint8, device=cuda))


@pytest.mark.parametrize("h,w", [(75, 75), (160, 214)])
def test_kernel_matches_plain_at_key_stride_key_counts(cuda, h, w):
    """K = 5,625 (57 keys in the last tile, K % 4 = 1) and 34,240."""
    g = torch.Generator(device=cuda).manual_seed(h)
    B, Q, H, D, C, Cm, E = 2, 100, 8, 32, 64, 256, 256
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    qn = rn(B, H, Q, D)
    qn = qn / qn.norm(dim=-1, keepdim=True)
    args = [qn, rn(B, C, h * w) * 0.3, torch.round(rn(B, Cm, h * w) * 2) / 4,
            torch.round(rn(B, Q, Cm) * 3), position_embedding_sine_factors(h, w, E // 2, cuda),
            rn(C, E) * 0.2, rn(C, E) * 0.2, rn(E, E) * 0.1, rn(E) * 0.1, rn(E) * 0.1]
    got = fused_uoms_cross_attention(*args)
    want = fused_uoms_cross_attention_plain(
        *[tuple(t.double() for t in a) if isinstance(a, tuple) else a.double() for a in args])
    np.testing.assert_allclose(got.double().cpu().numpy(), want.cpu().numpy(), atol=2e-5)


def test_stage1_queues_without_a_host_sync(cuda):
    image, xyz = tabletop_scene(2)
    image, xyz = torch.from_numpy(image).to(cuda), torch.from_numpy(xyz).to(cuda)
    cfg = get_config()
    cfg.mean_shift.num_seeds, cfg.test.max_instances, cfg.test.crop_size = 12, 4, 32
    preds = [decisive_predictor(seed=0), decisive_ucn_predictor(image, xyz, seed=0, cfg=cfg)]
    for pred in preds:
        pred.stage1(image, xyz)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for pred in preds:
            pred.stage1(image, xyz)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_stream_on_cuda_equals_call(cuda):
    scenes = [tuple(torch.from_numpy(a).to(cuda) for a in tabletop_scene(s)) for s in range(3)]
    cfg = get_config()
    cfg.mean_shift.num_seeds, cfg.test.max_instances, cfg.test.crop_size = 12, 4, 32
    for pred in (decisive_predictor(seed=0),
                 decisive_ucn_predictor(*scenes[0], seed=0, cfg=cfg)):
        want = [pred(img, xyz) for img, xyz in scenes]
        for depth in (1, 2):
            got = list(pred.stream(iter(scenes), depth=depth))
            assert all(torch.equal(a, b) for g, w in zip(got, want) for a, b in zip(g, w))
