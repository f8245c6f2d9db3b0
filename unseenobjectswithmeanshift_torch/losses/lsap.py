"""Linear sum assignment (rectangular Hungarian), solved on the host.

Port of ``unseenobjectswithmeanshift_tpu.losses.lsap.solve_lsap``: the
shortest-augmenting-path (Jonker-Volgenant) solver that scipy's
``linear_sum_assignment`` implements (Crouse 2016), with scipy's dual update
and the JAX solver's tie order: among the columns at the lowest reduced cost
an unassigned one wins, and among those (or among all, when none is
unassigned) the lowest index.

Why the host: a train step's matrices are at most [24 gts x 100 queries] an
image, a few per head. On the card the solve would be a loop of tiny
dependent launches, slower than the numpy loop here. The criterion copies
every head's cost matrices to the host in one device-to-host copy a step,
solves them here and sends the assignments back. The arithmetic is float32,
in the JAX solver's order, so the assignments equal its own, ties included.

Orientation: cost [R, C] with R <= C (rows = ground truths, columns =
queries); returns col4row [R] int32, -1 for rows past n_valid_rows.
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32


def _augmenting_path(cost, u, v, row4col, cur_row):
    """Shortest augmenting path from cur_row -> (sink, minVal, SR, SC, SP,
    path)."""
    R, C = cost.shape
    SR = np.zeros(R, bool)
    SC = np.zeros(C, bool)
    SP = np.full(C, np.inf, _F32)
    path = np.full(C, -1, np.int32)
    minVal, i = _F32(0.0), cur_row
    while True:
        SR[i] = True
        r = minVal + cost[i] - u[i] - v
        better = ~SC & (r < SP)
        SP[better] = r[better]
        path[better] = i
        masked = np.where(SC, _F32(np.inf), SP)
        lowest = masked.min()
        cand = ~SC & (masked == lowest)
        unassigned = cand & (row4col < 0)
        j = int(np.argmax(unassigned)) if unassigned.any() else int(np.argmax(cand))
        SC[j] = True
        minVal = lowest
        if row4col[j] < 0:
            return j, minVal, SR, SC, SP, path
        i = int(row4col[j])


def solve_lsap(cost, n_valid_rows: int):
    """cost [R, C] (R <= C): assign the first n_valid_rows rows. Returns
    col4row [R] int32 (-1 for rows past n_valid_rows)."""
    cost = np.asarray(cost, _F32)
    R, C = cost.shape
    u = np.zeros(R, _F32)
    v = np.zeros(C, _F32)
    row4col = np.full(C, -1, np.int32)
    col4row = np.full(R, -1, np.int32)
    for cur_row in range(min(int(n_valid_rows), R)):
        sink, minVal, SR, SC, SP, path = _augmenting_path(cost, u, v, row4col, cur_row)
        # dual update (scipy rectangular_lsap), with col4row before the augment
        u[cur_row] += minVal
        other = SR & (np.arange(R) != cur_row)
        sp_at_assigned = SP[np.clip(col4row, 0, C - 1)]
        u = np.where(other, u + minVal - sp_at_assigned, u).astype(_F32)
        v = np.where(SC, v + SP - minVal, v).astype(_F32)
        # augment along the alternating path
        j = sink
        while True:
            i = int(path[j])
            row4col[j] = i
            prev = col4row[i]
            col4row[i] = j
            if i == cur_row:
                break
            j = int(prev)
    return col4row


def solve_matches(C, n_valid):
    """C [..., Q, G] numpy cost matrices, n_valid [...] valid gt counts ->
    matched query per gt slot [..., G] int32 (-1 where invalid)."""
    C = np.asarray(C, _F32)
    flat = C.reshape((-1,) + C.shape[-2:])
    counts = np.asarray(n_valid).reshape(-1)
    out = np.stack([solve_lsap(c.T, int(n)) for c, n in zip(flat, counts)])
    return out.reshape(C.shape[:-2] + (C.shape[-1],))
