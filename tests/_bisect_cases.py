"""Vectors for the bisection k-selection tests: the cases its one-launch
kernel must get right (all zero, subnormal, k = n, ties across the
threshold, n below 32, fewer non-zeros than k).

numpy only (no JAX), so the card tests can use them.  A case is
``(name, k)``; :func:`edge_row` makes its vector from a seed.
"""

import numpy as np

FLT_MIN = np.finfo(np.float32).tiny

EDGE_CASES = [("all_zero", 10), ("subnormal", 10), ("subnormal_mix", 20),
              ("subnormal_mix", 50), ("subnormal_mix", 60),
              ("near_flt_min", 100), ("near_flt_min", 2000), ("ties", 1),
              ("ties", 1200), ("ties", 4096), ("tiny_n", 1), ("tiny_n", 5),
              ("tiny_n", 17), ("few_nonzeros", 60), ("few_nonzeros", 7)]


def edge_row(case: str, rng) -> np.ndarray:
    if case == "all_zero":
        return np.zeros(3000, np.float32)
    if case == "subnormal":                   # every value subnormal
        return (rng.standard_normal(1000) * 1e-40).astype(np.float32)
    if case == "subnormal_mix":               # 50 normals among subnormals
        x = rng.standard_normal(2000) * 1e-40
        x[rng.choice(2000, 50, replace=False)] = rng.standard_normal(50)
        return x.astype(np.float32)
    if case == "near_flt_min":                # the bracket near FLT_MIN
        return (rng.uniform(0.25, 4.0, 2000) * FLT_MIN
                * np.sign(rng.standard_normal(2000))).astype(np.float32)
    if case == "ties":                        # ties across the threshold
        x = np.where(rng.random(4096) < 0.3, 0.75, rng.uniform(0, 1, 4096))
        return (x * np.sign(rng.standard_normal(4096))).astype(np.float32)
    if case == "tiny_n":                      # n below 32
        return rng.standard_normal(17).astype(np.float32)
    if case == "few_nonzeros":                # fewer non-zeros than k (R1)
        x = np.zeros(3000, np.float32)
        x[rng.choice(3000, 7, replace=False)] = rng.standard_normal(7)
        return x
    raise ValueError(case)
