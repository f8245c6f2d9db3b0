"""Sweep the launch plan of the UCN mean-shift kernels on one NVIDIA GPU.

    python scripts/sweep_mean_shift_blocks.py

Times ``fps_seeds`` and ``mean_shift_seeds`` (CUDA events, median of 10 after
2 warm-ups) at the shapes of chip_smoke.py's UCN checks (B=1/N=307,200 and
B=20/N=50,176) for several values of the blocks-per-step targets
``FPS_BLOCKS`` and ``CLIMB_BLOCKS`` of ``ops/mean_shift_kernels.py``, the
default last again, and checks that every plan gives the same FPS output.
Imports no JAX.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import chip_smoke as cs
from unseenobjectswithmeanshift_torch.ops import mean_shift_kernels as msk


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    fps_default, climb_default = msk.FPS_BLOCKS, msk.CLIMB_BLOCKS
    for name, (B, N) in cs.UCN_SHAPES.items():
        X, first, _ = cs.clustered_unit_vectors(B, N)
        ref = msk.fps_seeds(X, first, cs.SEEDS)
        for blocks in (264, 528, 1056, 2112, fps_default):
            msk.FPS_BLOCKS = blocks
            same = all(torch.equal(a, b) for a, b in zip(msk.fps_seeds(X, first, cs.SEEDS), ref))
            ms = cs.time_ms(lambda: msk.fps_seeds(X, first, cs.SEEDS), 2, 10)
            print(f"sweep fps {name} blocks={blocks} ms={ms:.3f} same={same}", flush=True)
        msk.FPS_BLOCKS = fps_default
        for blocks in (132, 264, 528, 1056, climb_default):
            msk.CLIMB_BLOCKS = blocks
            ms = cs.time_ms(lambda: msk.mean_shift_seeds(X, first, cs.KAPPA, cs.SEEDS, cs.ITERS),
                            2, 10)
            print(f"sweep climb {name} blocks={blocks} mean_shift_seeds_ms={ms:.3f}", flush=True)
        msk.CLIMB_BLOCKS = climb_default


if __name__ == "__main__":
    main()
