"""Federated learning environment: Algorithm 5 data splitting + Eq. 18
unbalancedness + the five environment parameters of Table III.

The port's numpy copy of ``repro/fed/environment.py``: the same seeds give
the same splits.

``split_data`` reproduces the paper's split exactly: every client holds
[Classes per Client] classes and a fraction φ_i (Eq. 18) of the data; splits
are non-overlapping.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

__all__ = ["FedEnvironment", "volume_fractions", "split_data"]


@dataclasses.dataclass(frozen=True)
class FedEnvironment:
    """Table III base configuration."""

    n_clients: int = 100
    participation: float = 0.1       # η
    classes_per_client: int = 10     # c
    batch_size: int = 20             # b
    balancedness: float = 1.0        # γ  (Eq. 18)
    alpha: float = 0.1               # α  (Eq. 18 minimum-volume floor)

    @property
    def participants_per_round(self) -> int:
        return max(1, int(round(self.participation * self.n_clients)))


def volume_fractions(n: int, gamma: float, alpha: float = 0.1) -> np.ndarray:
    """Eq. 18:  φ_i = α/n + (1-α)·γ^i / Σ_j γ^j."""
    i = np.arange(1, n + 1, dtype=np.float64)
    g = gamma ** i
    phi = alpha / n + (1 - alpha) * g / g.sum()
    return phi / phi.sum()


def split_data(labels: np.ndarray, env: FedEnvironment,
               seed: int = 0) -> List[np.ndarray]:
    """Algorithm 5: returns per-client index arrays into the dataset."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    by_class = [list(rng.permutation(np.flatnonzero(labels == j)))
                for j in range(n_classes)]
    phi = volume_fractions(env.n_clients, env.balancedness, env.alpha)
    n_total = len(labels)
    splits: List[np.ndarray] = []
    for i in range(env.n_clients):
        budget = int(phi[i] * n_total)
        per_class = max(1, budget // env.classes_per_client)
        # visit classes in order of remaining pool size (randomly rotated) so
        # depletion never fragments a client across > classes_per_client
        # classes -- every client ends with exactly c classes (Alg. 5 intent).
        start = int(rng.integers(0, n_classes))
        order = sorted(range(n_classes),
                       key=lambda j: (-len(by_class[j]),
                                      (j - start) % n_classes))
        take: list[int] = []
        classes_used = 0
        for k in order:
            if budget <= 0 or classes_used >= env.classes_per_client:
                break
            t = min(budget, per_class, len(by_class[k]))
            if t <= 0:
                continue
            take.extend(by_class[k][:t])
            del by_class[k][:t]
            budget -= t
            classes_used += 1
        splits.append(np.asarray(take, dtype=np.int64))
    return splits
