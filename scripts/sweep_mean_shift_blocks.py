"""Sweep the launch plans of the UCN mean-shift kernels on one NVIDIA GPU.

    python scripts/sweep_mean_shift_blocks.py

At the shapes of chip_smoke.py's UCN checks (B=1/N=307,200 and
B=20/N=50,176) it times, with CUDA events (median of 10 after 2 warm-ups):

- ``fps_seeds`` under variants of ``ops/mean_shift_kernels.fps_plan``, which
  differ in how much of X each block of the persistent kernel holds on chip:
  the plan as it stands, 0 / 16 register rows per lane group, 0 / 8 /
  16 / 24 / 32 MiB of X kept in the L2, half the shared-memory rows, and
  nothing (every row read from device memory at every step); each must give
  the same seeds and indices as the plan;
- the FPS kernel's cost per step when every row is on chip (B=1, N=4,224:
  32 rows a block), which is the barrier, the partial reduction and the
  seed row: what a step costs beyond its rows;
- ``mean_shift_seeds`` with the climbing kernel's key splits as
  ``climb_plan`` picks them and as one wave of blocks would take them
  (floor(SMs / B) splits an image).

Prints one line per case and the card's name and power limit. Imports no
JAX.
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import chip_smoke as cs
from unseenobjectswithmeanshift_torch.ops import mean_shift_kernels as msk


def fps_variants(plan):
    """{name: plan} of the FPS plan's variants: the same slices, with less or
    more of X held on chip."""
    rows, grid = plan["rows_per_block"], plan["grid"]
    out = {"plan": plan}
    if rows > plan["resident_rows"]:
        for reg in (0, msk.FPS_REG_ROWS):
            out[f"registers_{reg}"] = {**plan, "register_rows": reg}
        on_chip = min(rows, plan["resident_rows"] + plan["register_rows"] * msk.FPS_ROWS_PER_PASS)
        for mib in (0, 8, 16, 24, 32):
            l2 = min(rows - on_chip, (mib << 20) // (grid * 4 * msk.EMBED_DIM))
            out[f"l2_{mib}MiB"] = {**plan, "l2_rows": l2}
    for name, res in (("shared_half", plan["resident_rows"] // 2), ("nothing_on_chip", 0)):
        smem = plan["smem_bytes"] - 4 * msk.EMBED_DIM * (plan["resident_rows"] - res)
        out[name] = {**plan, "resident_rows": res, "smem_bytes": smem}
    out["nothing_on_chip"].update(register_rows=0, l2_rows=0)
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    fps_plan, climb_plan = msk.fps_plan, msk.climb_plan
    limits = msk.device_limits("cuda")
    try:
        for name, (B, N) in {**cs.UCN_SHAPES, "on_chip_B1_N4224": (1, 4224)}.items():
            X, first, _ = cs.clustered_unit_vectors(B, N)
            ref = msk.fps_seeds(X, first, cs.SEEDS)
            for variant, plan in fps_variants(fps_plan(B, N, **limits)).items():
                msk.fps_plan = lambda *a, plan=plan, **k: plan
                out = msk.fps_seeds(X, first, cs.SEEDS)
                same = all(torch.equal(a, b) for a, b in zip(out, ref))
                ms = cs.time_ms(lambda: msk.fps_seeds(X, first, cs.SEEDS), 2, 10)
                msk.fps_plan = fps_plan
                print(f"sweep fps {name} {variant}: ms={ms:.3f} per_step_us="
                      f"{ms / (cs.SEEDS - 1) * 1e3:.2f} resident_rows={plan['resident_rows']} "
                      f"register_rows={plan['register_rows']} l2_rows={plan['l2_rows']} "
                      f"same={same}", flush=True)
                if not same:
                    raise AssertionError(f"FPS plan {variant} changed the seeds at {name}")
            if name not in cs.UCN_SHAPES:
                continue
            one_wave = max(1, limits["sms"] // B)
            keys = -(-(-(-N // one_wave)) // msk.CLIMB_TILE) * msk.CLIMB_TILE
            for variant, plan in (("one_wave", {"keys_per_block": keys, "nsplit": -(-N // keys)}),
                                  ("plan", climb_plan(B, N, limits["sms"]))):
                msk.climb_plan = lambda *a, plan=plan: plan
                ms = cs.time_ms(lambda: msk.mean_shift_seeds(X, first, cs.KAPPA, cs.SEEDS,
                                                             cs.ITERS), 2, 10)
                msk.climb_plan = climb_plan
                print(f"sweep climb {name} {variant}: nsplit={plan['nsplit']} "
                      f"mean_shift_seeds_ms={ms:.3f}", flush=True)
    finally:
        msk.fps_plan, msk.climb_plan = fps_plan, climb_plan


if __name__ == "__main__":
    main()
