"""Time the two masked-attention kernels of csrc/masked_attention.cu on one
NVIDIA GPU, and how the fused kernel's time grows with its input width.

    python scripts/sweep_masked_attention.py

At the shapes of chip_smoke.py's masked_attention phase (H=8, Q=100, D=32;
B=1/K=307,200 and B=20/K=50,176) it times, with CUDA events in turns
(median of 5 after 2 warm-ups):

- ``masked_hypersphere_attention`` with k and v as [B, H, K, D] and as
  [B, H, D, K] (``kv_transposed``);
- ``fused_masked_hypersphere_attention`` at E = 32, 64, 128 and 256 input
  channels (one to eight 32-channel stages a tile, the weights on chip) and
  at E = 288 (nine stages, the weights streamed). The growth from E = 32 to
  E = 256, over seven stages, is what a projection stage costs; the time at
  E = 32 less one stage is the rest: the count pass, the attention and the
  reduction.

Prints one line per case and the card's name and power limit. Imports no
JAX.
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import chip_smoke as cs
from unseenobjectswithmeanshift_torch.ops.pallas_attention import (
    fused_masked_hypersphere_attention, masked_hypersphere_attention,
)

SHAPES = {"stage1_B1_K307200": (1, 480 * 640), "crops_B20_K50176": (20, 224 * 224)}
WIDTHS = (32, 64, 128, 256, 288)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for name, (B, K) in SHAPES.items():
        qn, k, v, logits, _ = cs.attention_inputs(B, K)
        kT, vT = k.transpose(2, 3).contiguous(), v.transpose(2, 3).contiguous()
        fns = {"masked": lambda: masked_hypersphere_attention(qn, k, v, logits),
               "masked_kv_transposed": lambda: masked_hypersphere_attention(
                   qn, kT, vT, logits, kv_transposed=True)}
        inputs = {}
        for e in WIDTHS:
            g = torch.Generator(device="cuda").manual_seed(e)
            pos = torch.rand(K, e, generator=g, device="cuda") * 2.0 - 1.0
            inputs[e] = cs.attention_inputs(B, K, seed=e, e=e, pos=pos)[4]
            fns[f"fused_E{e}"] = (lambda p: lambda: fused_masked_hypersphere_attention(
                qn, *p, logits))(inputs[e])
        times = cs.time_in_turns(fns)
        for case, ms in times.items():
            print(f"{name} {case}: {ms:.3f} ms", flush=True)
        per_stage = (times["fused_E256"] - times["fused_E32"]) / 7
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        block_tiles = -(-K // 64) * B * cs.H / sms      # (tile, head) blocks an SM runs
        print(f"{name} fused: {per_stage:.4f} ms a 32-channel stage over all tiles "
              f"({per_stage / block_tiles * 1e3:.3f} us a tile and head on each SM); "
              f"the rest (E = 32 less one stage) {times['fused_E32'] - per_stage:.3f} ms",
              flush=True)
        del qn, k, v, logits, kT, vT, inputs, fns
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
