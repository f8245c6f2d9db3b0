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
from unseenobjectswithmeanshift_torch.ops.fused_cross_attention import (
    fused_uoms_cross_attention, fused_uoms_cross_attention_plain, tile_occupancy,
    unmasked_keys,
)
from unseenobjectswithmeanshift_torch.ops.mean_shift import seed_hill_climbing
from unseenobjectswithmeanshift_torch.ops.mean_shift_kernels import (
    fps_seeds, fps_seeds_plain, mean_shift_seeds,
)
from unseenobjectswithmeanshift_torch.ops.pallas_attention import (
    fused_masked_hypersphere_attention, fused_masked_hypersphere_attention_plain,
    masked_hypersphere_attention, masked_hypersphere_attention_plain,
)
from chip_smoke import CLIMB_TOL, FPS_TOL, decisive_predictor, decisive_ucn_predictor

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
                                           (2, 100, 777, [0, 1]), (2, 128, 64, None)])
def test_kernel_matches_plain(cuda, B, Q, K, present):
    # full-width heads; K not a multiple of the 64-key tile; absent images
    args = [torch.from_numpy(a).to(cuda) for a in make_inputs(0, B, Q, K)]
    p = None if present is None else torch.tensor(present, dtype=torch.bool, device=cuda)
    before = fused_uoms_cross_attention.launches
    got = fused_uoms_cross_attention(*args, present=p)
    torch.cuda.synchronize()
    assert fused_uoms_cross_attention.launches == before + 1
    want = fused_uoms_cross_attention_plain(*[a.double() for a in args], present=p)
    # against the plain version in fp64: the kernel's fp32 error is ~1e-6
    # (measured at K = 307,200 by chip_smoke.py); masks are exact on both sides
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
    """[B, N, 64] unit rows around k directions, 1% copied rows, and 4
    isolated directions at 3 positions each (exact ties the farthest-point
    chain reaches). -> (X, groups [4, 3] sorted positions)."""
    rng = np.random.RandomState(seed)
    c = rng.randn(B, k, d)
    c /= np.linalg.norm(c, axis=-1, keepdims=True)
    X = c[np.arange(B)[:, None], rng.randint(0, k, (B, N))] + 0.06 * rng.randn(B, N, d)
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
    with pytest.raises(ValueError):                       # width 32: the kernels take 64
        fps_seeds(X[..., :32].contiguous(), 0, 10)
    with pytest.raises(ValueError):
        mean_shift_seeds(X.transpose(0, 1).contiguous().transpose(0, 1), 0, 20.0, 10, 2)
    with pytest.raises(ValueError):                       # first index on another device
        fps_seeds(X, torch.zeros(2, dtype=torch.int32), 10)
    with pytest.raises(TypeError):
        fps_seeds(X, torch.zeros(2, device=cuda), 10)
    with pytest.raises(ValueError):                       # 4 threads a seed, 512 at most
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


def mha_inputs(seed, B, Q, K, H=8, D=32, guard=True):
    rng = np.random.RandomState(seed)
    qn = rng.randn(B, H, Q, D).astype(np.float32)
    qn /= np.linalg.norm(qn, axis=-1, keepdims=True)
    logits = rng.randn(B, Q, K).astype(np.float32)
    if guard:
        logits[:, [0, 3]] = -1.0 - np.abs(logits[:, [0, 3]])
    return qn, rng.randn(B, H, K, D).astype(np.float32), \
        rng.randn(B, H, K, D).astype(np.float32), logits


@pytest.mark.parametrize("B,Q,K,kv_transposed", [(1, 100, 4096, False), (3, 17, 1000, True),
                                                 (2, 128, 777, False), (2, 100, 70, True)])
def test_masked_attention_kernel_matches_plain(cuda, B, Q, K, kv_transposed):
    qn, k, v, logits = mha_inputs(B + K, B, Q, K)
    if kv_transposed:
        k, v = k.transpose(0, 1, 3, 2).copy(), v.transpose(0, 1, 3, 2).copy()
    args = [torch.from_numpy(a).to(cuda) for a in (qn, k, v, logits)]
    before = masked_hypersphere_attention.launches
    got = masked_hypersphere_attention(*args, kv_transposed=kv_transposed, k_normalized=False)
    torch.cuda.synchronize()
    assert masked_hypersphere_attention.launches == before + 1
    want = masked_hypersphere_attention_plain(*[a.double() for a in args],
                                              kv_transposed=kv_transposed)
    # chip_smoke.py holds the kernel at 2e-5 from fp64 at K = 307,200
    np.testing.assert_allclose(got.double().cpu().numpy(), want.cpu().numpy(), atol=2e-5)


@pytest.mark.parametrize("B,Q,K,E", [(1, 100, 4096, 256), (2, 16, 777, 96)])
def test_fused_masked_attention_kernel_matches_plain(cuda, B, Q, K, E):
    rng = np.random.RandomState(K)
    H, D = 8, 32
    qn, _, _, logits = mha_inputs(K, B, Q, K)
    f32 = np.float32
    rest = [rng.randn(B, K, E).astype(f32) * 0.3, rng.randn(K, E).astype(f32) * 0.3,
            rng.randn(E, H * D).astype(f32) * 0.1, rng.randn(H * D).astype(f32) * 0.1,
            rng.randn(E, H * D).astype(f32) * 0.1, rng.randn(H * D).astype(f32) * 0.1]
    args = [torch.from_numpy(a).to(cuda) for a in [qn, *rest, logits]]
    before = fused_masked_hypersphere_attention.launches
    got = fused_masked_hypersphere_attention(*args)
    torch.cuda.synchronize()
    assert fused_masked_hypersphere_attention.launches == before + 1
    want = fused_masked_hypersphere_attention_plain(*[a.double() for a in args])
    np.testing.assert_allclose(got.double().cpu().numpy(), want.cpu().numpy(), atol=2e-5)


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
    with pytest.raises(ValueError):
        fused_masked_hypersphere_attention(qn, torch.zeros(1, 64, 256, device=cuda),
                                           torch.zeros(64, 256, device=cuda),
                                           torch.zeros(256, 128, device=cuda),
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
