"""Masked vMF (hypersphere) attention with a fixed maximum, over keys and
values that are given or projected on the fly.

Port of ``unseenobjectswithmeanshift_tpu.ops.pallas_attention`` (the same
module name, so that a reader finds the counterpart), with the same function
names and signatures, less the TPU's ``block_k`` and ``interpret``:

- ``masked_hypersphere_attention``: over k and v already projected
  ([B, H, K, D], or [B, H, D, K] with ``kv_transposed``); k is L2-normalized
  per head on the tile, as the TPU kernel does, so raw k may be passed;
- ``fused_masked_hypersphere_attention``: k = (base + pos) wk + bk and
  v = base wv + bv are computed per tile from the E-wide features.

Both attend where ``mask_logits`` [B, Q, K] >= 0; a row with no such key
attends everywhere (the decoder's all-masked-row guard). The weights are
exp(kappa (q . k^ - 1)): q and k^ are unit vectors, so the maximum is fixed
and no running maximum is needed. Output [B, H, Q, D], not yet normalized.

On a CUDA tensor each wrapper launches the hand-written kernel in
``csrc/masked_attention.cu`` (every product on the tensor cores in 3xTF32;
D = 32, Q <= 128, any H, K and E; anything else raises); on a CPU tensor it
runs the plain PyTorch version beside it. There is no other fallback. Each
wrapper counts its launches in ``.launches``. No model path calls either
function, as in the JAX package, whose decoder takes the fused
cross-attention instead (``ops/fused_cross_attention.py``).
"""

from __future__ import annotations

import ctypes

import torch

from .fused_cross_attention import (
    HEAD_DIM, MAX_QUERIES, TILE_KEYS, _check, masked_vmf_attention_tiles, unmasked_keys,
)
from .fused_cross_attention import launch_plan as _xattn_plan

_lib = None
# The fused kernel projects E in stages of PROJ_CHUNK channels (EC in the
# .cu) and sums each stage from zero before adding it to the running sum with
# round-to-nearest: the tensor cores add by truncation, and one chain over
# E = 256 lands 2-3x further from fp64 (tests/test_torch_masked_attention_tf32.py).
PROJ_CHUNK = 32
RES_MAX_E = 256      # padded E up to which the fused kernel keeps a head's weights on chip
PROJ_COLUMNS = 64    # projected columns of a head: 32 of k, 32 of v (NW in the .cu)
# resident blocks per SM: masked_hypersphere_attention (72 KB of shared
# memory, <= 128 registers) and the fused kernel (up to 217 KB)
BLOCKS_PER_SM = {"masked": 2, "fused": 1}
# A block sums its split tile by tile: each tile's O and row sums start from
# zero and join the running sums with one fp32 add, so a split of n tiles is
# a chain of n adds. At B=1, K=307,200 both kernels take 33 splits of 146
# tiles, at B=20, K=50,176 28 of 28 and 14 of 56 (132 SMs); the cap bounds
# the chain for any shape.
MAX_TILES_PER_SPLIT = 256
# Shared memory of the attention pass, mirroring smem_bytes in the .cu
# (tests/test_torch_cuda.py compares the two on the card).
_SPLIT_FLOATS = 4 * TILE_KEYS * HEAD_DIM     # k^ and v, hi and lo
_MASK_WORDS = MAX_QUERIES * TILE_KEYS // 32  # a tile's mask words


def padded_channels(E: int) -> int:
    """E rounded up to whole projection stages."""
    return -(-E // PROJ_CHUNK) * PROJ_CHUNK


def smem_bytes(fused: bool, E: int = 0) -> int:
    """Dynamic shared memory of the attention pass, in bytes: row 5's two
    ring stages of raw k, v (64 x 36 floats each) and mask words; row 6's
    resident weights (or streamed weight stages), three stages of base and
    pos (64 x 36 floats each), two tiles of mask words and the ring's six
    mbarriers; both the split k^ and v, and the guard flags."""
    if not fused:
        raw = TILE_KEYS * (HEAD_DIM + 4)
        return 4 * (_SPLIT_FLOATS + 2 * (2 * raw + _MASK_WORDS)) + 4 * MAX_QUERIES
    e_pad = padded_channels(E)
    res = e_pad <= RES_MAX_E
    slot = 2 * TILE_KEYS * (PROJ_CHUNK + 4)
    if not res:
        slot += 2 * PROJ_COLUMNS * PROJ_CHUNK
    weights = 2 * PROJ_COLUMNS * e_pad if res else 0
    return (4 * (weights + 3 * slot + _SPLIT_FLOATS) + 4 * 2 * _MASK_WORDS + 4 * MAX_QUERIES
            + 8 * 2 * 3)


def launch_plan(B: int, H: int, K: int, sm_count: int, fused: bool):
    """(nsplit, tiles_per_split) of either kernel: the cross-attention's
    plan (``ops/fused_cross_attention.launch_plan``) with this kernel's
    resident blocks per SM, splits of at most MAX_TILES_PER_SPLIT tiles and,
    for the fused kernel, a tile step to price loading the head's weights."""
    return _xattn_plan(B, H, K, sm_count, BLOCKS_PER_SM["fused" if fused else "masked"],
                       MAX_TILES_PER_SPLIT, int(fused))


def _normalize_heads(k):
    return k / torch.sqrt((k * k).sum(-1, keepdim=True) + 1e-24)


def masked_hypersphere_attention_plain(qn, k, v, mask_logits, kappa: float = 30.0,
                                       kv_transposed: bool = False,
                                       k_normalized: bool = True):
    """Plain PyTorch version. k is normalized whatever k_normalized says, as in
    the TPU kernel (normalizing twice changes k by rounding only)."""
    if kv_transposed:
        k, v = k.transpose(-1, -2), v.transpose(-1, -2)
    return masked_vmf_attention_tiles(qn, _normalize_heads(k), v, unmasked_keys(mask_logits),
                                      kappa)


def fused_masked_hypersphere_attention_plain(qn, base, pos, wk, bk, wv, bv, mask_logits,
                                             kappa: float = 30.0):
    """Plain PyTorch version: project, normalize k per head, attend."""
    B, H, Q, D = qn.shape
    K = base.shape[1]
    heads = lambda x: x.reshape(B, K, H, D).transpose(1, 2)     # [B, H, K, D]
    k = heads((base + pos[None]) @ wk + bk)
    v = heads(base @ wv + bv)
    return masked_vmf_attention_tiles(qn, _normalize_heads(k), v, unmasked_keys(mask_logits),
                                      kappa)


def _library():
    global _lib
    if _lib is None:
        from . import _build

        lib = _build.load("masked_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.uoms_masked_attn.argtypes = [p] * 3 + [i] + [p] * 5 + [i] * 7 + [f, p]
        lib.uoms_masked_attn.restype = i
        lib.uoms_fused_masked_attn.argtypes = [p] * 13 + [i] * 8 + [f, p]
        lib.uoms_fused_masked_attn.restype = i
        lib.uoms_mattn_smem_bytes.argtypes = [i, i]
        lib.uoms_mattn_smem_bytes.restype = i
        lib.uoms_mattn_error_string.argtypes = [i]
        lib.uoms_mattn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _prepare(name, qn, mask_logits, K, fused):
    """Checks what both kernels take and allocates the output and scratch.
    -> (out, bits, cnt, partial, nsplit, tiles_per_split)."""
    B, H, Q, D = qn.shape
    if D != HEAD_DIM or not 1 <= Q <= MAX_QUERIES:
        raise ValueError(f"{name}: the kernel takes D={HEAD_DIM} and 1 <= Q <= {MAX_QUERIES}; "
                         f"got Q={Q}, D={D}")
    if K < 1:
        raise ValueError(f"{name}: no keys")
    _check("qn", qn, (B, H, Q, D))
    _check("mask_logits", mask_logits, (B, Q, K))
    dev = qn.device
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    nsplit, tiles_per_split = launch_plan(B, H, K, sm_count, fused)
    out = torch.empty((B, H, Q, D), dtype=torch.float32, device=dev)
    bits = torch.empty((B, Q, -(-K // 32)), dtype=torch.int32, device=dev)
    cnt = torch.empty((B, Q), dtype=torch.int32, device=dev)
    partial = torch.empty((B, nsplit, H, Q, D + 1), dtype=torch.float32, device=dev)
    return out, bits, cnt, partial, nsplit, tiles_per_split


def _raise_on(name, rc, lib):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({lib.uoms_mattn_error_string(rc).decode()})")


def masked_hypersphere_attention(qn, k, v, mask_logits, kappa: float = 30.0,
                                 kv_transposed: bool = False, k_normalized: bool = True):
    """qn [B, H, Q, D] L2-normalized per head; k, v [B, H, K, D], or
    [B, H, D, K] with kv_transposed; k raw or normalized (it is normalized on
    the tile either way); mask_logits [B, Q, K]. -> [B, H, Q, D], not yet
    normalized. Kernel on CUDA tensors, plain version on CPU tensors."""
    if qn.device.type == "cpu":
        return masked_hypersphere_attention_plain(qn, k, v, mask_logits, kappa,
                                                  kv_transposed, k_normalized)
    name = "masked_hypersphere_attention"
    B, H, Q, D = qn.shape
    K = k.shape[3] if kv_transposed else k.shape[2]
    shape = (B, H, D, K) if kv_transposed else (B, H, K, D)
    _check("k", k, shape)
    _check("v", v, shape)
    out, bits, cnt, partial, nsplit, tps = _prepare(name, qn, mask_logits, K, fused=False)
    lib = _library()
    rc = lib.uoms_masked_attn(
        qn.data_ptr(), k.data_ptr(), v.data_ptr(), int(kv_transposed), mask_logits.data_ptr(),
        out.data_ptr(), bits.data_ptr(), cnt.data_ptr(), partial.data_ptr(), B, H, Q, D, K,
        nsplit, tps, float(kappa), torch.cuda.current_stream(qn.device).cuda_stream)
    _raise_on(name, rc, lib)
    masked_hypersphere_attention.launches += 1
    return out


masked_hypersphere_attention.launches = 0


def fused_masked_hypersphere_attention(qn, base, pos, wk, bk, wv, bv, mask_logits,
                                       kappa: float = 30.0):
    """qn [B, H, Q, D] normalized queries; base [B, K, E] features; pos [K, E]
    positional encoding (batch-shared, added to the keys only); wk/wv
    [E, H D]; bk/bv [H D]; mask_logits [B, Q, K]. -> [B, H, Q, D], not yet
    normalized. Kernel on CUDA tensors, plain version on CPU tensors."""
    if qn.device.type == "cpu":
        return fused_masked_hypersphere_attention_plain(qn, base, pos, wk, bk, wv, bv,
                                                        mask_logits, kappa)
    name = "fused_masked_hypersphere_attention"
    B, H, Q, D = qn.shape
    K, E = base.shape[1], base.shape[2]
    for arg, t, shape in (("base", base, (B, K, E)), ("pos", pos, (K, E)),
                          ("wk", wk, (E, H * D)), ("bk", bk, (H * D,)),
                          ("wv", wv, (E, H * D)), ("bv", bv, (H * D,))):
        _check(arg, t, shape)
    if E < 1:
        raise ValueError(f"{name}: no input channels")
    out, bits, cnt, partial, nsplit, tps = _prepare(name, qn, mask_logits, K, fused=True)
    ws = torch.empty((H, 2, PROJ_COLUMNS, padded_channels(E)), dtype=torch.float32,
                     device=qn.device)
    lib = _library()
    rc = lib.uoms_fused_masked_attn(
        qn.data_ptr(), base.data_ptr(), pos.data_ptr(), wk.data_ptr(), bk.data_ptr(),
        wv.data_ptr(), bv.data_ptr(), mask_logits.data_ptr(), out.data_ptr(), ws.data_ptr(),
        bits.data_ptr(), cnt.data_ptr(), partial.data_ptr(), B, H, Q, D, E, K, nsplit, tps,
        float(kappa), torch.cuda.current_stream(qn.device).cuda_stream)
    _raise_on(name, rc, lib)
    fused_masked_hypersphere_attention.launches += 1
    return out


fused_masked_hypersphere_attention.launches = 0
