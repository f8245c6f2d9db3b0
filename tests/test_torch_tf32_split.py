"""A numpy model of the 3xTF32 products of csrc/fused_cross_attention.cu,
held against fp64 on the CPU.

The kernel splits every fp32 operand as a = a_hi + a_lo, a_hi = rna(a) and
a_lo = rna(a - a_hi), where rna rounds to TF32 (10 mantissa bits, to
nearest, ties away from zero: cvt.rna.tf32.f32, which the kernel computes as
(bits + 0x1000) & 0xffffe000), and forms a b ~ a_lo b_hi + a_hi b_lo +
a_hi b_hi with fp32 accumulation on the tensor cores. This file pins that
formula: the rounding itself, and the whole cross-attention computed with
every product in 3xTF32 (and, for contrast, in plain 1xTF32) against fp64,
at full width (8 heads, 100 queries, C = 64, Cm = 256) over 2,048 keys;
and the mask logits alone on fp32 inputs that TF32 does not hold exactly,
held by the check that chip_smoke.py applies to the kernel's mask bits.
"""

import numpy as np
import pytest
import torch

from chip_smoke import MASK_MARGIN, mask_mismatches
from unseenobjectswithmeanshift_torch.ops.fused_cross_attention import pack_mask_bits


def tf32_rna(x):
    """x (fp32) rounded to TF32, ties away from zero, as fp32."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(np.float32(x) - hi)


def mm(a, b, mode):
    """a @ b in fp32 with the products of `mode`: "fp32", "3xtf32" or
    "1xtf32" (batched over leading axes)."""
    a, b = a.astype(np.float32), b.astype(np.float32)
    if mode == "fp32":
        return a @ b
    ah, al = split(a)
    bh, bl = split(b)
    if mode == "1xtf32":
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def check_inputs(seed=0, B=2, H=8, Q=100, D=32, C=64, Cm=256, K=2048):
    """The kernel's check inputs (chip_smoke.make_inputs): exact mask logits
    (integers times 1/4), queries 0-3 masked everywhere (the guard),
    positional input uniform in [-1, 1]."""
    rng = np.random.RandomState(seed)
    E = H * D
    f32 = np.float32
    qn = rng.randn(B, H, Q, D).astype(f32)
    qn /= np.linalg.norm(qn, axis=-1, keepdims=True)
    mf = (np.round(rng.randn(B, Cm, K) * 2) / 4).astype(f32)
    mf[:, 0] = np.abs(mf[:, 0]) + 0.25
    me = np.round(rng.randn(B, Q, Cm) * 3).astype(f32)
    me[:, :4] = 0.0
    me[:, :4, 0] = -5.0
    return dict(qn=qn, featT=(rng.randn(B, C, K) * 0.3).astype(f32), mfT=mf, me=me,
                pos=rng.uniform(-1, 1, (E, K)).astype(f32),
                awk=(rng.randn(C, E) * 0.2).astype(f32), awv=(rng.randn(C, E) * 0.2).astype(f32),
                wk=(rng.randn(E, E) * 0.1).astype(f32), ck=(rng.randn(E) * 0.1).astype(f32),
                cv=(rng.randn(E) * 0.1).astype(f32))


def attention(x, mode, kappa=30.0):
    """The kernel's function with its products (mask logits, k/v
    projections, q.k^, p.v) in `mode`; everything else in the working type
    (fp64 for mode "fp64", else fp32). -> [B, H, Q, D]."""
    f = (lambda a: a.astype(np.float64)) if mode == "fp64" else (lambda a: a.astype(np.float32))
    prod = (lambda a, b: f(a) @ f(b)) if mode == "fp64" else (lambda a, b: mm(a, b, mode))
    qn, featT, mfT, me = (f(x[k]) for k in ("qn", "featT", "mfT", "me"))
    B, H, Q, D = qn.shape
    K = featT.shape[-1]
    P = f(x["pos"]).T @ f(x["wk"]) + f(x["ck"])          # pos table: plain fp32 FMA
    feat = featT.transpose(0, 2, 1)
    k = prod(feat, x["awk"]) + P
    v = prod(feat, x["awv"]) + f(x["cv"])
    kh = k.reshape(B, K, H, D).transpose(0, 2, 1, 3)
    vh = v.reshape(B, K, H, D).transpose(0, 2, 1, 3)
    kn = kh / np.sqrt((kh * kh).sum(-1, keepdims=True) + 1e-24)
    masked = prod(me, mfT) < 0
    unmasked = ~masked | masked.all(-1, keepdims=True)
    s = prod(qn, kn.transpose(0, 1, 3, 2))
    p = np.exp(kappa * s - kappa) * unmasked[:, None]
    num = prod(p, vh)
    return num / p.sum(-1, keepdims=True)


def test_rna_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)               # TF32 spacing at 1
    cases = {one + ulp * np.float32(0.25): one, one + ulp * np.float32(0.75): one + ulp,
             one + ulp * np.float32(0.5): one + ulp,                   # tie: away from zero
             -(one + ulp * np.float32(0.5)): -(one + ulp),
             np.float32(1.5) + ulp * np.float32(0.5): np.float32(1.5) + ulp,
             np.float32(2.0) - ulp * np.float32(0.25): np.float32(2.0)}  # carries into the exponent
    for x, want in cases.items():
        assert tf32_rna(np.float32(x)) == np.float32(want), x
    assert tf32_rna(np.float32(np.inf)) == np.inf


def test_split_is_exact_to_two_to_the_minus_22():
    rng = np.random.RandomState(0)
    x = (rng.randn(100_000) * 10.0 ** rng.uniform(-6, 6, 100_000)).astype(np.float32)
    hi, lo = split(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    rel_hi = np.abs(x.astype(np.float64) - hi) / np.abs(x)
    rel = np.abs(x.astype(np.float64) - hi - lo) / np.abs(x)
    assert rel_hi.max() <= 2.0 ** -11          # half a TF32 ulp
    assert rel.max() <= 2.0 ** -21             # what the dropped lo * lo leaves, ~2^-22


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_attention_against_fp64(seed):
    x = check_inputs(seed)
    want = attention(x, "fp64")
    errs = {mode: float(np.abs(attention(x, mode) - want).max())
            for mode in ("fp32", "3xtf32", "1xtf32")}
    # measured at these inputs (seeds 0, 1): fp32 2.3e-6, 3.1e-6; 3xTF32
    # 2.9e-6, 3.8e-6; 1xTF32 2.6e-3, 2.2e-3 (rounding q.k^ to 10 bits moves
    # exp(30 s) by up to 30 x 2^-11). 3xTF32 stays near fp32, 5x under the
    # 2e-5 gate; 1xTF32 is 100x over it
    assert errs["3xtf32"] < 5e-6, errs
    assert errs["3xtf32"] < 3 * errs["fp32"] + 1e-6, errs
    assert errs["1xtf32"] > 2e-5, errs
    print(f"seed {seed}: max abs error vs fp64: " +
          ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))


@pytest.mark.parametrize("seed", [0, 1])
def test_mask_check_takes_3xtf32_and_refuses_1xtf32(seed):
    # chip_smoke's mask check (mask_mismatches, MASK_MARGIN) on the mask
    # logits of each product model, random fp32 inputs as in
    # chip_smoke.mask_inputs, 2 x 100 x 2,048 keys. Measured at these inputs
    # (seeds 0, 1): in 3xTF32 no bit differs from fp64; in 1xTF32 33 and 44
    # bits do, 30 and 41 of them beyond the 1.9e-6 margin, the largest at
    # |logit| / scale = 5.8e-5 and 4.5e-5. The numpy model accumulates in
    # fp32 with rounding, the tensor cores by truncation: chip_smoke.py
    # prints the kernel's own largest flipped |logit| / scale
    rng = np.random.RandomState(seed)
    B, Q, Cm, K = 2, 100, 256, 2048
    me = rng.randn(B, Q, Cm).astype(np.float32)
    mf = (rng.randn(B, Cm, K) * 0.5).astype(np.float32)
    mf[:, 0] = np.abs(mf[:, 0]) + 0.25
    me[:, :4] = 0.0
    me[:, :4, 0] = -5.0
    found = {}
    for mode in ("3xtf32", "1xtf32"):
        unmasked = torch.from_numpy(mm(me, mf, mode) >= 0)
        bits = pack_mask_bits(unmasked)
        found[mode] = mask_mismatches(bits, unmasked.sum(-1, dtype=torch.int32),
                                      torch.from_numpy(me), torch.from_numpy(mf))
    print(f"seed {seed}, margin {MASK_MARGIN:.2e}: {found}")
    assert found["3xtf32"]["bad"] == 0 and found["3xtf32"]["worst"] < MASK_MARGIN / 4, found
    assert found["1xtf32"]["bad"] > 0, found
    assert all(f["cnt_ok"] for f in found.values())
