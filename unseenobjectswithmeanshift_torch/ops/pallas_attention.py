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
``csrc/masked_attention.cu`` (D = 32, H a multiple of 4, Q <= 128; anything
else raises); on a CPU tensor it runs the plain PyTorch version beside it.
There is no other fallback. Each wrapper counts its launches in
``.launches``. No model path calls either function, as in the JAX package,
whose decoder takes the fused cross-attention instead
(``ops/fused_cross_attention.py``).
"""

from __future__ import annotations

import ctypes

import torch

from .fused_cross_attention import (
    HEAD_DIM, HEADS_PER_BLOCK, MAX_PAIRS, _check, launch_plan, masked_vmf_attention_tiles,
    unmasked_keys,
)

_lib = None
# A thread sums its split's keys one after the other in fp32. With v of unit
# scale, 112 tiles a split (B=20, K=50,176 under launch_plan's two waves) put
# the kernel 2.4e-5 from fp64 on the H100; 32 tiles (2,048 keys) bound the
# chain (at B=1, K=307,200 this is 150 splits instead of 132).
MAX_TILES_PER_SPLIT = 32


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
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.uoms_masked_attn.argtypes = [p] * 3 + [i] * 2 + [p] * 10 + [i] * 8 + [
            ctypes.c_float, i, p]
        lib.uoms_masked_attn.restype = i
        lib.uoms_mattn_smem_bytes.argtypes = [i, i]
        lib.uoms_mattn_smem_bytes.restype = i
        lib.uoms_mattn_error_string.argtypes = [i]
        lib.uoms_mattn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(name, qn, mask_logits, K, kappa, k=None, v=None, sk=0, sd=0, proj=None):
    """Checks the shapes the kernel takes, allocates the output and scratch,
    and launches csrc/masked_attention.cu. -> out [B, H, Q, D]."""
    B, H, Q, D = qn.shape
    if D != HEAD_DIM or H % HEADS_PER_BLOCK or HEADS_PER_BLOCK * Q > MAX_PAIRS:
        raise ValueError(f"{name}: the kernel takes D={HEAD_DIM}, H a multiple of "
                         f"{HEADS_PER_BLOCK} and Q <= {MAX_PAIRS // HEADS_PER_BLOCK}; "
                         f"got H={H}, Q={Q}, D={D}")
    if K < 1:
        raise ValueError(f"{name}: no keys")
    _check("qn", qn, (B, H, Q, D))
    _check("mask_logits", mask_logits, (B, Q, K))
    dev = qn.device
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    nsplit, tiles_per_split = launch_plan(B, H, K, sm_count, MAX_TILES_PER_SPLIT)
    out = torch.empty((B, H, Q, D), dtype=torch.float32, device=dev)
    cnt = torch.empty((B, Q), dtype=torch.int32, device=dev)
    partial = torch.empty((B, nsplit, H, Q, D + 1), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    base, pos, wk, bk, wv, bv = proj or (None,) * 6
    E = 0 if proj is None else base.shape[2]
    lib = _library()
    rc = lib.uoms_masked_attn(
        ptr(qn), ptr(k), ptr(v), sk, sd, ptr(base), ptr(pos), ptr(wk), ptr(bk), ptr(wv),
        ptr(bv), ptr(mask_logits), ptr(out), ptr(cnt), ptr(partial), B, H, Q, D, E, K,
        nsplit, tiles_per_split, float(kappa), int(proj is not None),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({lib.uoms_mattn_error_string(rc).decode()})")
    return out


def masked_hypersphere_attention(qn, k, v, mask_logits, kappa: float = 30.0,
                                 kv_transposed: bool = False, k_normalized: bool = True):
    """qn [B, H, Q, D] L2-normalized per head; k, v [B, H, K, D], or
    [B, H, D, K] with kv_transposed; k raw or normalized (it is normalized on
    the tile either way); mask_logits [B, Q, K]. -> [B, H, Q, D], not yet
    normalized. Kernel on CUDA tensors, plain version on CPU tensors."""
    if qn.device.type == "cpu":
        return masked_hypersphere_attention_plain(qn, k, v, mask_logits, kappa,
                                                  kv_transposed, k_normalized)
    B, H, Q, D = qn.shape
    K = k.shape[3] if kv_transposed else k.shape[2]
    shape = (B, H, D, K) if kv_transposed else (B, H, K, D)
    _check("k", k, shape)
    _check("v", v, shape)
    sk, sd = (1, K) if kv_transposed else (D, 1)
    out = _launch("masked_hypersphere_attention", qn, mask_logits, K, kappa, k=k, v=v,
                  sk=sk, sd=sd)
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
    B, H, Q, D = qn.shape
    K, E = base.shape[1], base.shape[2]
    for name, t, shape in (("base", base, (B, K, E)), ("pos", pos, (K, E)),
                           ("wk", wk, (E, H * D)), ("bk", bk, (H * D,)),
                           ("wv", wv, (E, H * D)), ("bv", bv, (H * D,))):
        _check(name, t, shape)
    out = _launch("fused_masked_hypersphere_attention", qn, mask_logits, K, kappa,
                  proj=(base, pos, wk, bk, wv, bv))
    fused_masked_hypersphere_attention.launches += 1
    return out


fused_masked_hypersphere_attention.launches = 0
