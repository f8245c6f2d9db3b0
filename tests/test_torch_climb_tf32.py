"""A numpy model of the 3xTF32 hill climbing of csrc/mean_shift_climb.cu,
held against fp64 on the CPU.

The kernel runs both products of a climbing step, S = Z X^T and W X with
W = exp(kappa S), on the tensor cores with every fp32 operand split hi/lo
(tests/test_torch_tf32_split.py pins the split) and fp32 accumulation; the
exponentials and the normalization stay fp32. The model does the same in
numpy at S = 100 seeds, kappa = 20 and 10 steps over a few thousand keys,
and holds it to chip_smoke.CLIMB_TOL against fp64, as chip_smoke.py holds
the kernel. Plain 1xTF32 products must fail that gate on random unit rows,
where a seed's own row dominates its weights and the TF32 rounding of X
(2^-11) reaches the climbed seed unaveraged; on clustered rows (here 6
directions over 3,000 keys) it averages out over many keys and stays under
the gate, which is why chip_smoke.py also holds the kernel on random rows.
"""

import numpy as np
import pytest

from chip_smoke import CLIMB_TOL
from test_torch_tf32_split import mm

SEEDS, KAPPA, ITERS, KEYS = 100, 20.0, 10, 3000


def climb(X, Z, mode):
    """ITERS steps of Z <- normalize(exp(KAPPA Z X^T) X) with the products in
    `mode` ("fp64", "fp32", "3xtf32" or "1xtf32")."""
    f = np.float64 if mode == "fp64" else np.float32
    X, Z = X.astype(f), Z.astype(f)
    prod = (lambda a, b: a @ b) if mode == "fp64" else (lambda a, b: mm(a, b, mode))
    for _ in range(ITERS):
        W = np.exp(f(KAPPA) * prod(Z, X.T)).astype(f)
        O = prod(W, X)
        Z = O / np.maximum(np.sqrt((O * O).sum(-1, keepdims=True)), f(1e-12))
    return Z


def rows(seed, clustered):
    """KEYS unit rows, random or around 6 directions (noise 0.06, as
    chip_smoke.clustered_unit_vectors); SEEDS of them as the seeds."""
    rng = np.random.RandomState(seed)
    X = rng.randn(KEYS, 64)
    if clustered:
        c = rng.randn(6, 64)
        c /= np.linalg.norm(c, axis=-1, keepdims=True)
        X = c[rng.randint(0, 6, KEYS)] + 0.06 * X
    X = (X / np.linalg.norm(X, axis=-1, keepdims=True)).astype(np.float32)
    return X, X[rng.choice(KEYS, SEEDS, replace=False)]


def errors(seed, clustered):
    X, Z = rows(seed, clustered)
    want = climb(X, Z, "fp64")
    errs = {mode: float(np.abs(climb(X, Z, mode) - want).max())
            for mode in ("fp32", "3xtf32", "1xtf32")}
    print(f"seed {seed}, clustered {clustered}: max abs error vs fp64: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    return errs


@pytest.mark.parametrize("seed", [0, 1])
def test_climb_gate_takes_3xtf32_and_refuses_1xtf32(seed):
    # measured (seeds 0, 1): fp32 1.5e-7, 1.5e-7; 3xTF32 1.4e-7, 1.3e-7;
    # 1xTF32 1.3e-4, 1.2e-4: 100x under and 6x over the 2e-5 gate
    errs = errors(seed, clustered=False)
    assert errs["3xtf32"] < CLIMB_TOL / 20, errs
    assert errs["3xtf32"] < 3 * errs["fp32"] + 1e-7, errs
    assert errs["1xtf32"] > 2 * CLIMB_TOL, errs


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_climbing_on_clustered_rows(seed):
    # measured (seeds 0, 1): 3xTF32 1.3e-7, 1.1e-7; 1xTF32 1.2e-5, 1.5e-5, under
    # the gate: clustered rows alone cannot tell the two apart
    errs = errors(seed, clustered=True)
    assert errs["3xtf32"] < CLIMB_TOL / 20, errs
    assert errs["3xtf32"] < 3 * errs["fp32"] + 1e-7, errs
    assert errs["1xtf32"] > 10 * errs["3xtf32"], errs
