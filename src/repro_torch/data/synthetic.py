"""Synthetic structured datasets (the container is offline -- no MNIST/CIFAR).

The port's numpy copy of ``repro/data/synthetic.py``: the same seeds give
the same arrays.

Classification: a Gaussian-mixture "digits" task -- each class has a random
template; samples are template + noise.  Separation is tuned so linear models
reach ~90% (like logreg@MNIST) and the task is learnable but not trivial.
Non-iid splits over CLASS labels behave exactly like the paper's splits: what
matters for the federated phenomena is the label skew, not the pixels.

LM: Zipf-distributed token streams with Markov class structure for the
transformer training examples.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["Dataset", "make_classification", "make_image_classification",
           "make_sequence_classification", "make_lm_tokens"]


class Dataset(NamedTuple):
    x: np.ndarray
    y: np.ndarray
    n_classes: int


def make_classification(seed: int = 0, n: int = 20000, d: int = 784,
                        n_classes: int = 10, sep: float = 2.2,
                        within_class_var: float = 1.0,
                        n_test: int = 2000) -> tuple[Dataset, Dataset]:
    """Flat-vector task (logreg / MLP analogue of MNIST).

    Returns (train, test) drawn from the SAME class templates.
    """
    rng = np.random.default_rng(seed)
    templates = rng.standard_normal((n_classes, d)).astype(np.float32)
    templates *= sep / np.linalg.norm(templates, axis=1, keepdims=True) * np.sqrt(d) / 10

    def draw(m):
        y = rng.integers(0, n_classes, size=m)
        x = templates[y] + within_class_var * rng.standard_normal((m, d)).astype(np.float32)
        return Dataset(x=x.astype(np.float32), y=y.astype(np.int32),
                       n_classes=n_classes)

    return draw(n), draw(n_test)


def make_image_classification(seed: int = 0, n: int = 20000, img: int = 32,
                              ch: int = 3, n_classes: int = 10,
                              sep: float = 1.5,
                              n_test: int = 2000) -> tuple[Dataset, Dataset]:
    """Image-shaped task (CNN analogue of CIFAR): smooth class templates.

    Returns (train, test) drawn from the SAME class templates.
    """
    rng = np.random.default_rng(seed)
    freq = rng.standard_normal((n_classes, 4, 4, ch)).astype(np.float32)
    # upsample low-frequency templates to img x img (structured, conv-friendly)
    templates = np.repeat(np.repeat(freq, img // 4, axis=1), img // 4, axis=2)
    templates *= sep

    def draw(m):
        y = rng.integers(0, n_classes, size=m)
        x = templates[y] + rng.standard_normal((m, img, img, ch)).astype(np.float32)
        return Dataset(x=x.astype(np.float32), y=y.astype(np.int32),
                       n_classes=n_classes)

    return draw(n), draw(n_test)


def make_sequence_classification(seed: int = 0, n: int = 20000, t: int = 28,
                                 d: int = 28, n_classes: int = 10,
                                 sep: float = 1.5,
                                 n_test: int = 2000) -> tuple[Dataset, Dataset]:
    """Sequence task (LSTM analogue of Fashion-MNIST rows).

    Returns (train, test) drawn from the SAME class templates.
    """
    rng = np.random.default_rng(seed)
    templates = rng.standard_normal((n_classes, t, d)).astype(np.float32) * sep

    def draw(m):
        y = rng.integers(0, n_classes, size=m)
        x = templates[y] + rng.standard_normal((m, t, d)).astype(np.float32)
        return Dataset(x=x.astype(np.float32), y=y.astype(np.int32),
                       n_classes=n_classes)

    return draw(n), draw(n_test)


def make_lm_tokens(seed: int = 0, n_tokens: int = 1 << 20, vocab: int = 512,
                   n_states: int = 8) -> np.ndarray:
    """Markov-modulated Zipf token stream: learnable bigram structure."""
    rng = np.random.default_rng(seed)
    # per-state Zipf over a shuffled vocab
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    base = 1.0 / ranks ** 1.1
    perms = [rng.permutation(vocab) for _ in range(n_states)]
    probs = np.stack([base[np.argsort(p)] for p in perms])
    probs /= probs.sum(axis=1, keepdims=True)
    trans = rng.dirichlet(np.ones(n_states) * 0.3, size=n_states)
    out = np.empty(n_tokens, dtype=np.int32)
    state = 0
    # vectorized-ish: sample in blocks with a fixed state per block of 64
    block = 64
    for i in range(0, n_tokens, block):
        state = rng.choice(n_states, p=trans[state])
        m = min(block, n_tokens - i)
        out[i : i + m] = rng.choice(vocab, size=m, p=probs[state])
    return out
