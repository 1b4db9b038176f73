"""Datasets for the SAE experiments (paper §6) — a copy of
``repro.sae.data`` (pure numpy), kept here so the port never imports the
JAX package. Same seeds give the same arrays in both packages.

  * ``make_classification`` — numpy port of the scikit-learn generator the
    paper uses for its synthetic benchmark (clusters on hypercube vertices,
    n_informative features carrying signal, the rest pure noise).
  * ``make_lung_surrogate`` — the LUNG metabolomics dataset (Mathe et al.) is
    not redistributable/offline; this generator matches its published
    statistics (1005 samples: 469 NSCLC + 536 controls, 2944 features,
    ~40 informative, multiplicative log-normal noise). Every reported number
    on it is labeled "LUNG-surrogate" in EXPERIMENTS.md.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["make_classification", "make_lung_surrogate", "train_test_split"]


def make_classification(n_samples: int = 1000, n_features: int = 10_000,
                        n_informative: int = 64, n_classes: int = 2,
                        class_sep: float = 0.8, flip_y: float = 0.01,
                        n_clusters_per_class: int = 1, seed: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Port of sklearn.datasets.make_classification (hypercube mode).

    Returns (X, y, informative_idx) — the ground-truth informative feature
    indices let benchmarks score feature-selection quality.
    """
    rng = np.random.default_rng(seed)
    n_clusters = n_classes * n_clusters_per_class

    # cluster centroids on hypercube vertices, scaled by 2*class_sep
    def hypercube_vertices(k, d):
        if d < 30:
            # distinct binary vertices
            idx = rng.choice(2 ** min(d, 62), size=k, replace=False)
            return np.array([[(i >> b) & 1 for b in range(d)] for i in idx],
                            dtype=np.float64)
        return rng.integers(0, 2, size=(k, d)).astype(np.float64)

    centroids = hypercube_vertices(n_clusters, n_informative)
    centroids *= 2 * class_sep
    centroids -= class_sep

    counts = np.full(n_clusters, n_samples // n_clusters)
    counts[: n_samples % n_clusters] += 1

    X_inf = np.empty((n_samples, n_informative))
    y = np.empty(n_samples, dtype=np.int64)
    pos = 0
    for c in range(n_clusters):
        k = counts[c]
        block = rng.normal(size=(k, n_informative))
        # random linear mixing within the cluster (sklearn's covariance trick)
        A = rng.uniform(-1, 1, size=(n_informative, n_informative))
        X_inf[pos:pos + k] = block @ A * 0.5 + centroids[c]
        y[pos:pos + k] = c % n_classes
        pos += k

    X = rng.normal(size=(n_samples, n_features))
    informative_idx = rng.choice(n_features, size=n_informative, replace=False)
    X[:, informative_idx] = X_inf

    # label noise
    flip = rng.uniform(size=n_samples) < flip_y
    y[flip] = rng.integers(0, n_classes, size=flip.sum())

    perm = rng.permutation(n_samples)
    return X[perm].astype(np.float32), y[perm], np.sort(informative_idx)


def make_lung_surrogate(n_samples: int = 1005, n_features: int = 2944,
                        n_informative: int = 40, effect: float = 0.6,
                        seed: int = 0):
    # effect=0.6 calibrated so the unconstrained SAE baseline lands at the
    # paper's LUNG baseline (~77% accuracy)
    """Metabolomics-like data: multiplicative log-normal noise; informative
    features shift the log-mean between cases (469) and controls (536).
    Returns raw intensities — apply the classical log-transform (as the paper
    does) before training."""
    rng = np.random.default_rng(seed)
    n_cases = 469 if n_samples == 1005 else n_samples // 2
    y = np.zeros(n_samples, dtype=np.int64)
    y[:n_cases] = 1

    base_mean = rng.uniform(2.0, 6.0, size=n_features)       # per-metabolite
    log_X = base_mean[None, :] + rng.normal(scale=1.0,
                                            size=(n_samples, n_features))
    informative_idx = rng.choice(n_features, size=n_informative, replace=False)
    signs = rng.choice([-1.0, 1.0], size=n_informative)
    log_X[:, informative_idx] += (y[:, None] * signs[None, :] * effect)

    X = np.exp(log_X)                                         # intensities
    perm = rng.permutation(n_samples)
    return X[perm].astype(np.float32), y[perm], np.sort(informative_idx)


def train_test_split(X, y, test_frac: float = 0.2, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = len(X)
    perm = rng.permutation(n)
    n_test = int(round(n * test_frac))
    te, tr = perm[:n_test], perm[n_test:]
    return X[tr], y[tr], X[te], y[te]
