"""The launch plans of the UCN mean-shift kernels, on the CPU.

``fps_plan`` cuts the B N rows of X into one slice per block of the
persistent FPS kernel (csrc/fps_seeds.cu); the kernel trusts it, and the C
entry only recomputes its shared-memory bytes. Here, at the limits of an
H100 (132 SMs, 227 KB of dynamic shared memory a block, 228 KB an SM with 1
KB reserved a block): every row of every image lies in exactly one slice, a
slice touches at most ``image_slots`` images, the (block, image) partials
have distinct segments (block + image) that are consecutive per image, the
resident rows and the running distances fit the shared-memory bytes, and
the grid never exceeds the blocks that can be resident at once; the rows kept
in the L2 stay within their budget.
"""

import numpy as np
import pytest

from unseenobjectswithmeanshift_torch.ops.mean_shift_kernels import (
    CLIMB_BLOCK_TILES, CLIMB_TILE, EMBED_DIM, FPS_L2_BYTES, FPS_RED_FLOATS, FPS_REG_ROWS,
    FPS_ROWS_PER_PASS, climb_plan, fps_plan,
)
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401

SMS, SMEM_PER_BLOCK, SMEM_PER_SM, RESERVED_PER_BLOCK = 132, 232_448, 233_472, 1024


@pytest.mark.parametrize("B,N", [(1, 50), (1, 1), (64, 1), (20, 1), (3, 1000), (20, 50_176),
                                 (64, 5003), (1, 307_200), (8, 307_200)])
def test_fps_plan_covers_every_row_once_and_fits(B, N):
    p = fps_plan(B, N, SMS, SMEM_PER_BLOCK)
    grid, rows, total = p["grid"], p["rows_per_block"], B * N
    covered = np.zeros(total, np.int32)
    segments, l2_held, streamed = {}, 0, 0
    for k in range(grid):
        lo, hi = k * rows, min((k + 1) * rows, total)
        assert lo < hi                                     # no empty block
        covered[lo:hi] += 1
        images = range(lo // N, (hi - 1) // N + 1)
        assert len(images) <= p["image_slots"]
        for b in images:
            segments.setdefault(b, []).append(k + b)
        on_chip = min(rows, p["resident_rows"] + p["register_rows"] * FPS_ROWS_PER_PASS)
        l2_held += min(max(0, hi - lo - on_chip), p["l2_rows"])
        streamed += max(0, hi - lo - on_chip - p["l2_rows"])
    assert (covered == 1).all()
    assert sorted(segments) == list(range(B))
    flat = [s for b in range(B) for s in segments[b]]
    assert len(set(flat)) == len(flat) and max(flat) < grid + B
    assert all(segments[b] == list(range(segments[b][0], segments[b][-1] + 1)) for b in range(B))
    assert (p["l2_held_rows"], p["streamed_rows"]) == (l2_held, streamed)
    assert l2_held * 4 * EMBED_DIM <= FPS_L2_BYTES
    assert p["l2_rows"] == min(rows - on_chip, FPS_L2_BYTES // (grid * 4 * EMBED_DIM))
    # the bytes: running distances, resident rows, seeds of every image slot
    assert 0 <= p["resident_rows"] <= rows
    assert p["register_rows"] in (0, FPS_REG_ROWS)
    assert p["register_rows"] == (FPS_REG_ROWS if p["resident_rows"] < rows else 0)
    assert p["smem_bytes"] == 4 * (p["image_slots"] * EMBED_DIM + FPS_RED_FLOATS
                                   + -(-rows // 4) * 4 + p["resident_rows"] * EMBED_DIM)
    assert p["smem_bytes"] <= SMEM_PER_BLOCK
    assert p["resident_rows"] == rows or SMEM_PER_BLOCK - p["smem_bytes"] < 4 * EMBED_DIM
    per_sm = SMEM_PER_SM // (p["smem_bytes"] + RESERVED_PER_BLOCK)
    assert 1 <= grid <= SMS * per_sm and grid <= SMS


def test_fps_plan_slices_cross_images_at_b20():
    # B = 20 crops: a slice may start in one image and end in the next
    p = fps_plan(20, 50_176, SMS, SMEM_PER_BLOCK)
    rows = p["rows_per_block"]
    crossing = [k for k in range(p["grid"]) if (k * rows) // 50_176 !=
                (min((k + 1) * rows, 20 * 50_176) - 1) // 50_176]
    assert p["image_slots"] == 2 and len(crossing) >= 19


def test_fps_plan_refuses_distances_that_do_not_fit():
    # one image of 8,000,000 rows: 60,607 rows a block, 242 KB of running
    # distances (images that fit alone are launched in groups instead)
    with pytest.raises(ValueError):
        fps_plan(1, 8_000_000, SMS, SMEM_PER_BLOCK)
    with pytest.raises(ValueError):
        fps_plan(0, 10, SMS, SMEM_PER_BLOCK)


@pytest.mark.parametrize("B,N,nsplit", [(1, 307_200, 130), (20, 50_176, 13), (3, 1000, 16),
                                         (200, 64, 1), (9, 50_176, 14)])
def test_climb_plan_takes_the_fewest_tile_times(B, N, nsplit):
    # one wave of 130 splits at B = 1; at B = 20 two waves of 260 blocks of 61
    # tiles (2 x 64 tile times) beat one of 120 blocks of 131 tiles (134)
    p = climb_plan(B, N, SMS)
    assert p["nsplit"] == nsplit
    keys = p["keys_per_block"]
    assert keys % CLIMB_TILE == 0 and p["nsplit"] * keys >= N > (p["nsplit"] - 1) * keys
    cost = lambda n, k: -(-B * n // SMS) * (k // CLIMB_TILE + CLIMB_BLOCK_TILES)
    for per_image in range(1, 4 * SMS // B + 1):
        k = -(-(-(-N // per_image)) // CLIMB_TILE) * CLIMB_TILE
        assert cost(p["nsplit"], keys) <= cost(-(-N // k), k)
