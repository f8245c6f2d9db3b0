"""A numpy model of the 3xTF32 products of csrc/masked_attention.cu, held
against fp64 on the CPU, and the kernels' launch plan and shared memory.

Both kernels run every product on the tensor cores with each fp32 operand
split hi/lo (tests/test_torch_tf32_split.py pins the split): S = q k^T over
D = 32, O = P V over each 64-key tile, and in the fused kernel the k/v
projections over E. The tensor cores add into their accumulator by
truncation; the model does the same (each 8-deep step's sum, plus the
accumulator, truncated to fp32), restarts the accumulator where the kernel
does (O and the row sums every tile, the projection every PROJ_CHUNK
channels) and joins the restarted sums with round-to-nearest fp32 adds. At
full width (8 heads, 100 queries, E = 256) over 1,024 keys it holds the
result to chip_smoke.TOL against fp64, as chip_smoke.py holds the kernels;
plain 1xTF32 products must fail that gate.
"""

import numpy as np
import pytest

from chip_smoke import TOL
from test_torch_tf32_split import split
from unseenobjectswithmeanshift_torch.models.position_encoding import position_embedding_sine
from unseenobjectswithmeanshift_torch.ops import pallas_attention as pa
from unseenobjectswithmeanshift_torch.ops.fused_cross_attention import TILE_KEYS
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401

H, Q, D, E, KAPPA = 8, 100, 32, 256, 30.0
SHARED_MEMORY_LIMIT = 232_448   # bytes of shared memory a block may use on the H100
GRID = (32, 32)   # key grid of the positional encoding: 1,024 keys


def trunc32(x):
    """float64 -> float32, rounded toward zero."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def tc_matmul(a, b, mode, chunk=None):
    """a [..., M, n] @ b [..., n, N] as the tensor cores compute it with the
    products in `mode` ("fp32", "3xtf32" or "1xtf32"): 8 channels a step, each
    step's products (in 3xTF32 lo.hi, hi.lo, hi.hi, one instruction each)
    summed with the accumulator and truncated to fp32; the accumulator starts
    from zero every `chunk` channels (once when None) and the chunks are
    added with round-to-nearest fp32 adds."""
    a, b = a.astype(np.float32), b.astype(np.float32)
    if mode == "fp32":
        return a @ b
    ah, al = split(a)
    bh, bl = split(b)
    terms = [(al, bh), (ah, bl), (ah, bh)] if mode == "3xtf32" else [(ah, bh)]
    n = a.shape[-1]
    chunk = chunk or n
    out = None
    for c0 in range(0, n, chunk):
        acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
        for k0 in range(c0, min(c0 + chunk, n), 8):
            for x, y in terms:
                acc = trunc32(acc.astype(np.float64) + x[..., k0:k0 + 8].astype(np.float64)
                              @ y[..., k0:k0 + 8, :].astype(np.float64))
        out = acc if out is None else out + acc
    return out


def attend(qn, k, v, logits, mode):
    """The kernels' attention with its products in `mode` ("fp64" for the
    reference): k normalized per head; S from zero over D; P = mask exp(kappa
    (s - 1)); each 64-key tile's O and row sums from zero, added tile by
    tile. qn [H, Q, D], k, v [H, K, D], logits [Q, K]. -> [H, Q, D]."""
    f = np.float64 if mode == "fp64" else np.float32
    qn, k, v = qn.astype(f), k.astype(f), v.astype(f)
    kn = k / np.sqrt((k * k).sum(-1, keepdims=True) + f(1e-24))
    masked = logits < 0
    unmasked = ~masked | masked.all(-1, keepdims=True)
    if mode == "fp64":
        p = np.exp(KAPPA * (qn @ kn.transpose(0, 2, 1)) - KAPPA) * unmasked
        return (p @ v) / p.sum(-1, keepdims=True)
    s = tc_matmul(qn, kn.transpose(0, 2, 1), mode)
    c = np.float32(KAPPA * np.log2(np.e))
    p = (np.exp2(c * s - c) * unmasked).astype(np.float32)            # [H, Q, K]
    T = -(-p.shape[-1] // TILE_KEYS)
    pad = T * TILE_KEYS - p.shape[-1]
    pt = np.pad(p, ((0, 0), (0, 0), (0, pad))).reshape(H, Q, T, TILE_KEYS).transpose(0, 2, 1, 3)
    vt = np.pad(v, ((0, 0), (0, pad), (0, 0))).reshape(H, T, TILE_KEYS, D)
    o_tiles = tc_matmul(pt, vt, mode)                                   # [H, T, Q, D]
    r_tiles = pt.sum(-1, dtype=np.float32)                              # [H, T, Q]
    num, den = np.zeros((H, Q, D), np.float32), np.zeros((H, Q), np.float32)
    for t in range(T):
        num += o_tiles[:, t]
        den += r_tiles[:, t]
    return num / den[..., None]


def inputs(seed):
    """chip_smoke.attention_inputs' scales at 1,024 keys: qn normalized, raw
    k and v, logits with rows 0-3 masked everywhere (the guard), base x 0.3,
    pos the sine encoding of a 32 x 32 grid, wk/wv x 0.06, bk/bv x 0.1."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    K = GRID[0] * GRID[1]
    qn = rng.randn(H, Q, D).astype(f32)
    qn /= np.linalg.norm(qn, axis=-1, keepdims=True)
    logits = rng.randn(Q, K).astype(f32)
    logits[:4] = -1.0 - np.abs(logits[:4])
    pos = position_embedding_sine(*GRID, E // 2, device="cpu").reshape(K, E).numpy()
    rn = lambda *shape, scale=1.0: (rng.randn(*shape) * scale).astype(f32)
    return dict(qn=qn, k=rn(H, K, D), v=rn(H, K, D), logits=logits, base=rn(K, E, scale=0.3),
                pos=pos, wk=rn(E, H * D, scale=0.06), bk=rn(H * D, scale=0.1),
                wv=rn(E, H * D, scale=0.06), bv=rn(H * D, scale=0.1))


def fused(x, mode, chunk=pa.PROJ_CHUNK):
    """Row 6: k = (base + pos) wk + bk, v = base wv + bv with the projection's
    products in `mode`, summed in chunks of `chunk` channels; then attend."""
    f = np.float64 if mode == "fp64" else np.float32
    base, pos = x["base"].astype(f), x["pos"].astype(f)
    if mode == "fp64":
        k, v = (base + pos) @ x["wk"].astype(f), base @ x["wv"].astype(f)
    else:
        k, v = tc_matmul(base + pos, x["wk"], mode, chunk), tc_matmul(base, x["wv"], mode, chunk)
    heads = lambda t: t.reshape(-1, H, D).transpose(1, 0, 2)
    return attend(x["qn"], heads(k + x["bk"].astype(f)), heads(v + x["bv"].astype(f)),
                  x["logits"], mode)


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_attention_3xtf32_against_fp64(seed):
    x = inputs(seed)
    want = attend(x["qn"], x["k"], x["v"], x["logits"], "fp64")
    errs = {mode: float(np.abs(attend(x["qn"], x["k"], x["v"], x["logits"], mode) - want).max())
            for mode in ("fp32", "3xtf32", "1xtf32")}
    print(f"row 5, seed {seed}: max abs error vs fp64: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    assert errs["3xtf32"] < TOL / 2, errs
    assert errs["3xtf32"] < 3 * errs["fp32"] + 1e-6, errs
    assert errs["1xtf32"] > 2 * TOL, errs


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_projection_3xtf32_in_chunks_against_fp64(seed):
    x = inputs(seed)
    want = fused(x, "fp64")
    errs = {mode: float(np.abs(fused(x, mode) - want).max())
            for mode in ("fp32", "3xtf32", "1xtf32")}
    errs["3xtf32_one_chain"] = float(np.abs(fused(x, "3xtf32", chunk=None) - want).max())
    print(f"row 6, seed {seed}, chunks of {pa.PROJ_CHUNK}: max abs error vs fp64: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    assert errs["3xtf32"] < TOL / 2, errs
    assert errs["3xtf32"] < 3 * errs["fp32"] + 1e-6, errs
    assert errs["3xtf32"] < errs["3xtf32_one_chain"], errs
    assert errs["1xtf32"] > 2 * TOL, errs


PLAN_SHAPES = {"stage1_B1_K307200": (1, 307_200, 256), "crops_B20_K50176": (20, 50_176, 256),
               "ragged_B3_K777": (3, 777, 20)}


@pytest.mark.parametrize("kind", sorted(pa.BLOCKS_PER_SM))
@pytest.mark.parametrize("shape", sorted(PLAN_SHAPES))
def test_launch_plan_puts_every_tile_in_one_split(shape, kind):
    B, K, _ = PLAN_SHAPES[shape]
    nsplit, tps = pa.launch_plan(B, H, K, 132, fused=kind == "fused")
    ntiles = -(-K // TILE_KEYS)
    # the kernel's split s covers tiles [s tps, min((s + 1) tps, ntiles))
    owner = np.full(ntiles, -1)
    for s in range(nsplit):
        span = slice(s * tps, min((s + 1) * tps, ntiles))
        assert span.start < ntiles and (owner[span] == -1).all()   # no empty split, no overlap
        owner[span] = s
    assert (owner >= 0).all()
    assert 1 <= tps <= pa.MAX_TILES_PER_SPLIT


@pytest.mark.parametrize("shape", sorted(PLAN_SHAPES))
def test_shared_memory_within_the_block_limit(shape):
    E_in = PLAN_SHAPES[shape][2]
    masked, fused_b = pa.smem_bytes(False), pa.smem_bytes(True, E_in)
    assert masked <= SHARED_MEMORY_LIMIT and fused_b <= SHARED_MEMORY_LIMIT
    # two blocks of the masked kernel fit an SM (228 KB, 1 KB reserved a block)
    assert 2 * (masked + 1024) <= 233_472
    # a wider E streams the weights: still one block within the limit
    assert pa.smem_bytes(True, 4 * E) <= SHARED_MEMORY_LIMIT
    assert pa.smem_bytes(True, pa.RES_MAX_E) >= pa.smem_bytes(True, E_in)
