"""Fused masked vMF cross-attention: the decoder's cross-attention over every
pixel, from the 64-channel feature map to the attention output.

Port of ``unseenobjectswithmeanshift_tpu.ops.fused_cross_attention``
(``fused_uoms_cross_attention``, the dense branch and the tile-skipping one).
On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/fused_cross_attention.cu`` (see its header for the design and the
bound); on a CPU tensor it runs the plain PyTorch version below, which
computes the function of the JAX package's
``fused_uoms_cross_attention_reference``. There is no other fallback.

Tile skipping (``tile_skip=True``, the decoder's ``decoder.tile_skip``): a
64-key tile where no query of an image has an unmasked key (``me . mf >= 0``,
with a query that has none anywhere counted as unmasked everywhere) adds
exact zeros, so it is skipped. The test is exact, so the output equals the
dense output bit for bit. The JAX package's planner (``plan_tile_skip`` with
the interval bound ``mf_tile_bounds``) and its guard re-run are TPU
machinery that an exact test makes unnecessary: they are not ported.

Inputs (K-minor layouts, as in the JAX package):
  qn [B, H, Q, D] L2-normalized queries;  featT [B, C, K] feature map;
  mfT [B, Cm, K] mask features;  me [B, Q, Cm] previous layer's mask embed;
  posT [E, K] positional encoding;  awk/awv [C, E] (input_proj folded in);
  wk [E, E] pos -> k kernel ([in, out]);  ck/cv [E];  present optional [B] bool.
Output [B, H, Q, D], not yet normalized; absent images give zeros.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

TILE_KEYS = 64       # keys per tile of the attention pass (TK in the .cu)
HEADS_PER_BLOCK = 4  # HPB in the .cu
HEAD_DIM = 32
MAX_PAIRS = 512      # HPB * Q threads per block at most
BLOCKS_PER_SM = 2    # target waves of blocks over the SMs

_argtypes_set = False


def unmasked_keys(mask_logits):
    """[B, Q, K] bool: the keys each query attends to. Masked where the logit
    is < 0; a query masked everywhere attends everywhere (the guard)."""
    masked = mask_logits < 0
    return ~masked | masked.all(-1, keepdim=True)


def tile_occupancy(unmasked, present=None):
    """[B, T] bool over the 64-key tiles: some query of the image has an
    unmasked key in the tile (absent images have none)."""
    B, Q, K = unmasked.shape
    T = -(-K // TILE_KEYS)
    u = F.pad(unmasked, (0, T * TILE_KEYS - K)).reshape(B, Q, T, TILE_KEYS)
    occ = u.any(-1).any(1)
    return occ if present is None else occ & present.bool()[:, None]


def masked_vmf_attention_tiles(qn, kn, vh, unmasked, kappa: float, tiles=None):
    """sum_t m p v_t / sum_t m p with p = exp(kappa (q . k^_t - 1)), the
    attention of the kernels, over the 64-key tiles of each image that
    ``tiles`` [B, T] marks (all tiles when None); an image with no tile gives
    zeros. qn [B, H, Q, D]; kn, vh [B, H, K, D]; unmasked [B, Q, K] bool.

    Each tile's partial sums are built with elementwise products only, key by
    key and channel by channel, and the partials of all T tiles are summed in
    one reduction, with zeros for the tiles not computed. A tile that is not
    computed holds exact zeros in the full computation too, so the result does
    not depend on which tiles without an unmasked key are left out: bit for
    bit, as the kernel's skipping variant equals its dense one."""
    B, H, Q, D = qn.shape
    K = kn.shape[2]
    T = -(-K // TILE_KEYS)
    pad = T * TILE_KEYS - K
    kt = F.pad(kn, (0, 0, 0, pad)).reshape(B, H, T, TILE_KEYS, D)
    v1 = torch.cat([vh, torch.ones_like(vh[..., :1])], -1)           # [v | 1]
    vt = F.pad(v1, (0, 0, 0, pad)).reshape(B, H, T, TILE_KEYS, D + 1)
    ut = F.pad(unmasked, (0, pad)).reshape(B, Q, T, TILE_KEYS).transpose(1, 2)
    # tiles per step: on the CPU few enough that a step's products stay in
    # cache; the result does not depend on it
    step = T if qn.is_cuda else 16
    out = qn.new_zeros(B, H, Q, D + 1)
    for b in range(B):
        t_all = (torch.arange(T, device=qn.device) if tiles is None
                 else tiles[b].nonzero().flatten())
        part = qn.new_zeros(H, T, Q, D + 1)
        q = qn[b][:, None]                               # [H, 1, Q, D]
        for t_idx in t_all.split(step):
            k, v = kt[b][:, t_idx], vt[b][:, t_idx]      # [H, n, 64, D (+1)]
            s = q[..., 0, None] * k[:, :, None, :, 0]    # [H, n, Q, 64]
            for d in range(1, D):
                s = s + q[..., d, None] * k[:, :, None, :, d]
            p = torch.exp(kappa * s - kappa) * ut[b][t_idx].to(s.dtype)
            acc = p[..., 0, None] * v[:, :, None, 0]     # [H, n, Q, D + 1]
            for j in range(1, TILE_KEYS):
                acc = acc + p[..., j, None] * v[:, :, None, j]
            part[:, t_idx] = acc
        out[b] = part.sum(1)
    return out[..., :D] / out[..., D:].clamp_min(1e-30)


def fused_uoms_cross_attention_plain(qn, featT, mfT, me, posT, awk, awv, wk, ck,
                                     cv, present=None, kappa: float = 30.0,
                                     tile_skip: bool = False,
                                     tile_skip_force_all: bool = False):
    """Plain PyTorch version of the JAX reference (:505-528), with the
    kernel's fixed maximum. With tile_skip (and not tile_skip_force_all) the
    attention runs only over the tiles ``tile_occupancy`` keeps; the result
    is the same bits."""
    B, H, Q, D = qn.shape
    K = featT.shape[-1]
    feat = featT.transpose(1, 2)                       # [B, K, C]
    k = feat @ awk + (posT.T @ wk)[None] + ck          # [B, K, E]
    v = feat @ awv + cv
    kh = k.reshape(B, K, H, D).transpose(1, 2)         # [B, H, K, D]
    vh = v.reshape(B, K, H, D).transpose(1, 2)
    kn = kh / torch.sqrt((kh * kh).sum(-1, keepdim=True) + 1e-24)
    unmasked = unmasked_keys(me @ mfT)                 # [B, Q, K]
    tiles = (tile_occupancy(unmasked, present)
             if tile_skip and not tile_skip_force_all else None)
    out = masked_vmf_attention_tiles(qn, kn, vh, unmasked, kappa, tiles)
    if present is not None:
        out = torch.where(present.bool()[:, None, None, None], out, 0.0)
    return out


def _check(name, t, shape, dtype=torch.float32):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _library():
    global _argtypes_set
    from . import _build

    lib = _build.load("fused_cross_attention")
    if not _argtypes_set:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.uoms_fused_xattn.argtypes = [p] * 16 + [i] * 9 + [ctypes.c_float, i, p]
        lib.uoms_fused_xattn.restype = i
        lib.uoms_xattn_smem_bytes.argtypes = [i, i]
        lib.uoms_xattn_smem_bytes.restype = i
        lib.uoms_error_string.argtypes = [i]
        lib.uoms_error_string.restype = ctypes.c_char_p
        _argtypes_set = True
    return lib


def launch_plan(B: int, H: int, K: int, sm_count: int, max_tiles=None):
    """(nsplit, tiles_per_split): the key axis cut so that about
    BLOCKS_PER_SM waves of blocks cover the card, with no empty split and,
    given max_tiles, no split longer than that many tiles."""
    ntiles = -(-K // TILE_KEYS)
    blocks_per_split = B * (H // HEADS_PER_BLOCK)
    want = max(1, -(-BLOCKS_PER_SM * sm_count // blocks_per_split))
    tiles_per_split = -(-ntiles // min(want, ntiles))
    if max_tiles is not None:
        tiles_per_split = min(tiles_per_split, max_tiles)
    return -(-ntiles // tiles_per_split), tiles_per_split


def fused_uoms_cross_attention(qn, featT, mfT, me, posT, awk, awv, wk, ck, cv,
                               present=None, kappa: float = 30.0,
                               tile_skip: bool = False,
                               tile_skip_force_all: bool = False):
    """Kernel on CUDA tensors, plain version on CPU tensors. tile_skip runs the
    kernel's tile-skipping variant (same output, bit for bit);
    tile_skip_force_all runs that variant with every tile present (a control
    that measures the cost of the test). Counts its kernel launches in
    ``fused_uoms_cross_attention.launches``."""
    if qn.device.type == "cpu":
        return fused_uoms_cross_attention_plain(qn, featT, mfT, me, posT, awk, awv,
                                                wk, ck, cv, present, kappa, tile_skip,
                                                tile_skip_force_all)
    B, H, Q, D = qn.shape
    C, K = featT.shape[1], featT.shape[2]
    Cm, E = mfT.shape[1], H * D
    if D != HEAD_DIM or H % HEADS_PER_BLOCK or HEADS_PER_BLOCK * Q > MAX_PAIRS:
        raise ValueError(f"kernel takes D={HEAD_DIM}, H a multiple of "
                         f"{HEADS_PER_BLOCK} and Q <= {MAX_PAIRS // HEADS_PER_BLOCK}; "
                         f"got H={H}, Q={Q}, D={D}")
    for name, t, shape in (("qn", qn, (B, H, Q, D)), ("featT", featT, (B, C, K)),
                           ("mfT", mfT, (B, Cm, K)), ("me", me, (B, Q, Cm)),
                           ("posT", posT, (E, K)), ("awk", awk, (C, E)),
                           ("awv", awv, (C, E)), ("wk", wk, (E, E)),
                           ("ck", ck, (E,)), ("cv", cv, (E,))):
        _check(name, t, shape)
    if present is None:
        present_i = torch.ones(B, dtype=torch.int32, device=qn.device)
    else:
        if present.shape != (B,) or present.device != qn.device:
            raise ValueError("present must be a [B] tensor on the inputs' device")
        present_i = present.to(torch.int32).contiguous()
    lib = _library()
    if lib.uoms_xattn_smem_bytes(Q, C) > 227 * 1024:
        raise ValueError(f"C={C} needs more shared memory than a block has")

    sm_count = torch.cuda.get_device_properties(qn.device).multi_processor_count
    nsplit, tiles_per_split = launch_plan(B, H, K, sm_count)
    out = torch.empty((B, H, Q, D), dtype=torch.float32, device=qn.device)
    P = torch.empty((K, E), dtype=torch.float32, device=qn.device)
    bits = torch.empty((B, Q, -(-K // 32)), dtype=torch.int32, device=qn.device)
    cnt = torch.empty((B, Q), dtype=torch.int32, device=qn.device)
    partial = torch.empty((B, nsplit, H, Q, D + 1), dtype=torch.float32,
                          device=qn.device)
    stream = torch.cuda.current_stream(qn.device).cuda_stream
    rc = lib.uoms_fused_xattn(
        qn.data_ptr(), featT.data_ptr(), mfT.data_ptr(), me.data_ptr(),
        posT.data_ptr(), awk.data_ptr(), awv.data_ptr(), wk.data_ptr(),
        ck.data_ptr(), cv.data_ptr(), present_i.data_ptr(), out.data_ptr(),
        P.data_ptr(), bits.data_ptr(), cnt.data_ptr(), partial.data_ptr(),
        B, H, Q, D, C, Cm, K, nsplit, tiles_per_split, float(kappa),
        (2 if tile_skip_force_all else 1) if tile_skip else 0, stream)
    if rc != 0:
        raise RuntimeError(f"fused_uoms_cross_attention kernel launch failed: "
                           f"CUDA error {rc} ({lib.uoms_error_string(rc).decode()})")
    fused_uoms_cross_attention.launches += 1
    return out


fused_uoms_cross_attention.launches = 0
