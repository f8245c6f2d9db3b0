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
  posT the positional encoding, in one of two forms:
    general    posT [E, K];
    separable  a pair (pos_y [E/2, h], pos_x [E/2, w]) with h * w = K: key
               t = y * w + x has encoding [pos_y[:, y] | pos_x[:, x]], the
               layout of the sine encoding (``position_embedding_sine_factors``);
  awk/awv [C, E] (input_proj folded in);  wk [E, E] pos -> k kernel
  ([in, out]);  ck/cv [E];  present optional [B] bool.
Output [B, H, Q, D], not yet normalized; absent images give zeros.

The separable form is the decoder's: the kernel then projects h + w rows of
the encoding instead of K (``expand_pos`` gives the general form of the same
encoding, which the plain version computes with). Launches of the general
form's full pos projection are counted apart, in
``fused_uoms_cross_attention.general_pos_launches``.

Dtypes: every input (qn, featT, mfT, me, the positional input, awk, awv, wk,
ck, cv) is fp32, or every input is bf16 (the JAX package's serving dtype);
``qn`` sets which, and a mixed call raises. The output has qn's dtype, as
the JAX kernel's (:427, :486). With bf16 inputs the function is the JAX
kernel's on bf16 inputs (``_tile_body``, :171-235): every product takes
bf16 operands with fp32 accumulation; k^ is rounded to bf16 after its fp32
norm (:205), the weights p = exp2(c s - c) (:213) and v in [v | 1]
(:217-219) are rounded to bf16, and the row sums add the rounded weights;
the finalize is fp32 with the guard, and the result is cast to bf16. The
plain version does exactly that on the CPU: it converts the bf16 inputs to
fp32 (exact; a product of two bf16 values is exact in fp32, so an fp32
product of them is the bf16-operand product), computes in fp32 and rounds at
those three places. On a CUDA tensor bf16 inputs run the kernel's bf16
variant (counted in
``fused_uoms_cross_attention.launches`` with the fp32 one and apart in
``fused_uoms_cross_attention.bf16_launches``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

TILE_KEYS = 64       # keys per tile of the attention pass (TK in the .cu)
HEAD_DIM = 32
MAX_QUERIES = 128    # MAX_Q in the .cu: 8 tiles of 16 query rows
MAX_CHANNELS = 64    # MAX_C in the .cu; C a multiple of 8
BLOCKS_PER_SM = 2    # resident blocks per SM of the attention pass
LOG2E = 1.4426950408889634
DTYPES = (torch.float32, torch.bfloat16)   # the kernel's input dtypes

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


def _round_bf16(t):
    """t rounded to bf16 (nearest even), as a tensor of t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def masked_vmf_attention_tiles(qn, kn, vh, unmasked, kappa: float, tiles=None,
                               bf16_weights: bool = False):
    """sum_t m p v_t / sum_t m p with p = exp(kappa (q . k^_t - 1)), the
    attention of the kernels, over the 64-key tiles of each image that
    ``tiles`` [B, T] marks (all tiles when None); an image with no tile gives
    zeros. qn [B, H, Q, D]; kn, vh [B, H, K, D]; unmasked [B, Q, K] bool.
    bf16_weights: p = exp2(c s - c), c = kappa log2(e), rounded to bf16 (the
    JAX kernel's bf16 weights), in the work dtype of qn.

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
            if bf16_weights:
                c = kappa * LOG2E
                p = _round_bf16(torch.exp2(c * s - c)) * ut[b][t_idx].to(s.dtype)
            else:
                p = torch.exp(kappa * s - kappa) * ut[b][t_idx].to(s.dtype)
            acc = p[..., 0, None] * v[:, :, None, 0]     # [H, n, Q, D + 1]
            for j in range(1, TILE_KEYS):
                acc = acc + p[..., j, None] * v[:, :, None, j]
            part[:, t_idx] = acc
        out[b] = part.sum(1)
    return out[..., :D] / out[..., D:].clamp_min(1e-30)


def expand_pos(posT):
    """posT [E, K] from either form: a tensor is returned as it is; a pair
    (pos_y [E/2, h], pos_x [E/2, w]) becomes [pos_y[:, y] | pos_x[:, x]] at
    key y * w + x."""
    if isinstance(posT, torch.Tensor):
        return posT
    pos_y, pos_x = posT
    half, h, w = pos_y.shape[0], pos_y.shape[1], pos_x.shape[1]
    return torch.cat([pos_y[:, :, None].expand(half, h, w),
                      pos_x[:, None, :].expand(half, h, w)]).reshape(2 * half, h * w)


def fused_uoms_cross_attention_plain(qn, featT, mfT, me, posT, awk, awv, wk, ck,
                                     cv, present=None, kappa: float = 30.0,
                                     tile_skip: bool = False,
                                     tile_skip_force_all: bool = False):
    """Plain PyTorch version of the JAX reference (:505-528), with the
    kernel's fixed maximum. posT in either form (the separable one is
    expanded first). With tile_skip (and not tile_skip_force_all) the
    attention runs only over the tiles ``tile_occupancy`` keeps; the result
    is the same bits. bf16 inputs: the JAX kernel's bf16 semantics (module
    docstring), computed in fp32 and returned in bf16; fp32 and fp64 inputs
    compute in their own dtype."""
    B, H, Q, D = qn.shape
    K = featT.shape[-1]
    out_dtype = qn.dtype
    bf16 = out_dtype == torch.bfloat16
    wt = torch.float32 if bf16 else out_dtype           # work dtype
    rd = _round_bf16 if bf16 else (lambda t: t)
    qn, featT, mfT, me, awk, awv, wk, ck, cv = (
        t.to(wt) for t in (qn, featT, mfT, me, awk, awv, wk, ck, cv))
    posT = expand_pos(posT).to(wt)
    feat = featT.transpose(1, 2)                       # [B, K, C]
    k = feat @ awk + (posT.T @ wk)[None] + ck          # [B, K, E]
    v = feat @ awv + cv
    kh = k.reshape(B, K, H, D).transpose(1, 2)         # [B, H, K, D]
    vh = rd(v.reshape(B, K, H, D).transpose(1, 2))
    kn = rd(kh / torch.sqrt((kh * kh).sum(-1, keepdim=True) + 1e-24))
    unmasked = unmasked_keys(me @ mfT)                 # [B, Q, K]
    tiles = (tile_occupancy(unmasked, present)
             if tile_skip and not tile_skip_force_all else None)
    out = masked_vmf_attention_tiles(qn, kn, vh, unmasked, kappa, tiles, bf16_weights=bf16)
    if present is not None:
        out = torch.where(present.bool()[:, None, None, None], out, 0.0)
    return out.to(out_dtype)


def pack_mask_bits(unmasked):
    """[B, Q, K] bool -> [B, Q, ceil(K / 32)] int32 words, bit i of word j
    set when key 32 j + i is unmasked: the mask pass's layout."""
    B, Q, K = unmasked.shape
    words = -(-K // 32)
    u = F.pad(unmasked, (0, words * 32 - K)).reshape(B, Q, words, 32).long()
    w = (u << torch.arange(32, device=u.device)).sum(-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def mask_pass_plain(me, mfT, present=None):
    """Plain version of ``mask_pass`` (bf16 operands multiplied in fp32)."""
    wt = torch.promote_types(me.dtype, torch.float32)
    unmasked = (me.to(wt) @ mfT.to(wt)) >= 0
    if present is not None:
        unmasked = unmasked & present.bool()[:, None, None]
    return pack_mask_bits(unmasked), unmasked.sum(-1, dtype=torch.int32)


def mask_pass(me, mfT, present=None):
    """The cross-attention's mask pass alone: (bits [B, Q, ceil(K/32)]
    int32 in the layout of ``pack_mask_bits``, cnt [B, Q] int32) for
    ``me @ mfT >= 0``, before the guard; absent images give zeros. The
    kernel's own mask, for checking it on inputs of any precision; the
    decoder never calls this. me and mfT both fp32 or both bf16. Kernel on
    CUDA tensors (counted in ``mask_pass.launches``), plain version on CPU
    tensors."""
    if me.device.type == "cpu":
        return mask_pass_plain(me, mfT, present)
    B, Q, Cm = me.shape
    K = mfT.shape[-1]
    if Q > MAX_QUERIES:
        raise ValueError(f"kernel takes Q <= {MAX_QUERIES}; got Q={Q}")
    dtype = _input_dtype(me)
    _check("me", me, (B, Q, Cm), dtype)
    _check("mfT", mfT, (B, Cm, K), dtype)
    present_i = (torch.ones(B, dtype=torch.int32, device=me.device) if present is None
                 else present.to(device=me.device, dtype=torch.int32).contiguous())
    lib = _library()
    bits = torch.zeros((B, Q, -(-K // 32)), dtype=torch.int32, device=me.device)
    cnt = torch.empty((B, Q), dtype=torch.int32, device=me.device)
    entry = lib.uoms_mask_pass_bf16 if dtype == torch.bfloat16 else lib.uoms_mask_pass
    rc = entry(me.data_ptr(), mfT.data_ptr(), present_i.data_ptr(), bits.data_ptr(),
               cnt.data_ptr(), B, Q, Cm, K, torch.cuda.current_stream(me.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mask_pass kernel launch failed: "
                           f"CUDA error {rc} ({lib.uoms_error_string(rc).decode()})")
    mask_pass.launches += 1
    return bits, cnt


mask_pass.launches = 0


def _input_dtype(t):
    """The call's dtype, set by its first input: fp32 or bf16, else raises."""
    if t.dtype not in DTYPES:
        raise TypeError(f"the kernel takes {DTYPES} inputs, got {t.dtype}")
    return t.dtype


def _check(name, t, shape, dtype=torch.float32):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} like the call's other inputs (no mixed "
                        f"dtypes), got {t.dtype}")
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
        for entry in (lib.uoms_fused_xattn, lib.uoms_fused_xattn_bf16):
            entry.argtypes = [p] * 18 + [i] * 11 + [ctypes.c_float, i, p]
            entry.restype = i
        for entry in (lib.uoms_mask_pass, lib.uoms_mask_pass_bf16):
            entry.argtypes = [p] * 5 + [i] * 4 + [p]
            entry.restype = i
        lib.uoms_error_string.argtypes = [i]
        lib.uoms_error_string.restype = ctypes.c_char_p
        _argtypes_set = True
    return lib


@functools.lru_cache(maxsize=None)
def launch_plan(B: int, H: int, K: int, sm_count: int, blocks_per_sm: int = BLOCKS_PER_SM,
                max_tiles: int | None = None, setup_tiles: int = 0):
    """(nsplit, tiles_per_split) of the cross-attention (and, with their
    arguments, of the kernels of ``ops/pallas_attention.py``): of the cuts
    with no empty split and none longer than max_tiles, the one whose waves
    of blocks_per_sm * sm_count resident blocks take the fewest tile steps
    (waves x (tiles per split + setup_tiles), setup_tiles pricing a block's
    start), the fewest splits on a tie. A cut that leaves a wave nearly
    empty costs a whole wave: at B=20, K=50,176 (160 blocks a split, 264
    slots) two splits of 392 tiles take two waves, 784 steps; 28 splits of
    28 tiles take 476."""
    ntiles = -(-K // TILE_KEYS)
    blocks_per_split = B * H          # one block per (split, head, image)
    slots = blocks_per_sm * sm_count
    best = None
    for want in range(1, min(ntiles, 16 * -(-slots // blocks_per_split)) + 1):
        tiles_per_split = -(-ntiles // want)
        if max_tiles is not None and tiles_per_split > max_tiles:
            continue
        nsplit = -(-ntiles // tiles_per_split)
        steps = -(-nsplit * blocks_per_split // slots) * (tiles_per_split + setup_tiles)
        if best is None or steps < best[0]:
            best = (steps, nsplit, tiles_per_split)
    if best is None:   # every cut of the range is longer than max_tiles
        return -(-ntiles // max_tiles), max_tiles
    return best[1], best[2]


def fused_uoms_cross_attention(qn, featT, mfT, me, posT, awk, awv, wk, ck, cv,
                               present=None, kappa: float = 30.0,
                               tile_skip: bool = False,
                               tile_skip_force_all: bool = False):
    """Kernel on CUDA tensors, plain version on CPU tensors. posT is [E, K]
    or the pair (pos_y, pos_x) (module docstring). tile_skip runs the
    kernel's tile-skipping variant (same output, bit for bit);
    tile_skip_force_all runs that variant with every tile present (a control
    that measures the cost of the test). All inputs fp32 or all bf16 (module
    docstring); the output has qn's dtype. Counts its kernel launches in
    ``fused_uoms_cross_attention.launches``, those with the general posT in
    ``fused_uoms_cross_attention.general_pos_launches`` and those in bf16 in
    ``fused_uoms_cross_attention.bf16_launches``."""
    if qn.device.type == "cpu":
        return fused_uoms_cross_attention_plain(qn, featT, mfT, me, posT, awk, awv,
                                                wk, ck, cv, present, kappa, tile_skip,
                                                tile_skip_force_all)
    B, H, Q, D = qn.shape
    C, K = featT.shape[1], featT.shape[2]
    Cm, E = mfT.shape[1], H * D
    if D != HEAD_DIM or Q > MAX_QUERIES:
        raise ValueError(f"kernel takes D={HEAD_DIM} and Q <= {MAX_QUERIES}; "
                         f"got H={H}, Q={Q}, D={D}")
    if C % 8 or C > MAX_CHANNELS:
        raise ValueError(f"kernel takes C a multiple of 8 up to {MAX_CHANNELS}; got C={C}")
    dtype = _input_dtype(qn)
    general = isinstance(posT, torch.Tensor)
    if general:
        pos_a, pos_b, pos_h, pos_w = posT, None, K, 1
        pos_shapes = (("posT", posT, (E, K)),)
    else:
        pos_a, pos_b = posT
        pos_h, pos_w = pos_a.shape[-1], pos_b.shape[-1]
        if pos_h * pos_w != K:
            raise ValueError(f"pos_y [E/2, h] and pos_x [E/2, w] need h * w = K = {K}; "
                             f"got h={pos_h}, w={pos_w}")
        pos_shapes = (("pos_y", pos_a, (E // 2, pos_h)), ("pos_x", pos_b, (E // 2, pos_w)))
    for name, t, shape in (("qn", qn, (B, H, Q, D)), ("featT", featT, (B, C, K)),
                           ("mfT", mfT, (B, Cm, K)), ("me", me, (B, Q, Cm)), *pos_shapes,
                           ("awk", awk, (C, E)), ("awv", awv, (C, E)), ("wk", wk, (E, E)),
                           ("ck", ck, (E,)), ("cv", cv, (E,))):
        _check(name, t, shape, dtype)
    if present is None:
        present_i = torch.ones(B, dtype=torch.int32, device=qn.device)
    else:
        if present.shape != (B,) or present.device != qn.device:
            raise ValueError("present must be a [B] tensor on the inputs' device")
        present_i = present.to(torch.int32).contiguous()
    lib = _library()

    dev = qn.device
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    nsplit, tiles_per_split = launch_plan(B, H, K, sm_count)
    out = torch.empty((B, H, Q, D), dtype=dtype, device=dev)
    pos_row = torch.empty((K if general else pos_h, E), dtype=torch.float32, device=dev)
    pos_col = torch.empty((1 if general else pos_w, E), dtype=torch.float32, device=dev)
    bits = torch.empty((B, Q, -(-K // 32)), dtype=torch.int32, device=dev)
    cnt = torch.empty((B, Q), dtype=torch.int32, device=dev)
    partial = torch.empty((B, nsplit, H, Q, D + 1), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    entry = lib.uoms_fused_xattn_bf16 if dtype == torch.bfloat16 else lib.uoms_fused_xattn
    rc = entry(
        qn.data_ptr(), featT.data_ptr(), mfT.data_ptr(), me.data_ptr(), pos_a.data_ptr(),
        None if pos_b is None else pos_b.data_ptr(), awk.data_ptr(), awv.data_ptr(),
        wk.data_ptr(), ck.data_ptr(), cv.data_ptr(), present_i.data_ptr(), out.data_ptr(),
        pos_row.data_ptr(), pos_col.data_ptr(), bits.data_ptr(), cnt.data_ptr(),
        partial.data_ptr(), B, H, Q, D, C, Cm, K, pos_h, pos_w, nsplit, tiles_per_split,
        float(kappa), (2 if tile_skip_force_all else 1) if tile_skip else 0, stream)
    if rc != 0:
        raise RuntimeError(f"fused_uoms_cross_attention kernel launch failed: "
                           f"CUDA error {rc} ({lib.uoms_error_string(rc).decode()})")
    fused_uoms_cross_attention.launches += 1
    fused_uoms_cross_attention.general_pos_launches += int(general)
    fused_uoms_cross_attention.bf16_launches += int(dtype == torch.bfloat16)
    return out


fused_uoms_cross_attention.launches = 0
fused_uoms_cross_attention.general_pos_launches = 0
fused_uoms_cross_attention.bf16_launches = 0
