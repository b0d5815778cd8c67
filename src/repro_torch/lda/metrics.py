"""LDA evaluation metrics: planted-topic recovery and coherence."""

from __future__ import annotations

import numpy as np


def topic_recovery_score(phi_hat: np.ndarray, phi_true: np.ndarray) -> float:
    """Greedy-match inferred topics to planted topics; return mean
    (1 - total-variation distance) of the matching in [0, 1].

    ``phi_hat``, ``phi_true``: (V, K) column-stochastic.
    """
    phi_hat = np.asarray(phi_hat, np.float64)
    phi_true = np.asarray(phi_true, np.float64)
    K = phi_true.shape[1]
    Kh = phi_hat.shape[1]
    # pairwise TV distances (K, Kh)
    tv = 0.5 * np.abs(phi_true[:, :, None] - phi_hat[:, None, :]).sum(axis=0)
    score = 0.0
    used = set()
    for k in np.argsort(tv.min(axis=1)):  # match easiest first
        order = np.argsort(tv[k])
        pick = next(j for j in order if j not in used)
        used.add(pick)
        score += 1.0 - tv[k, pick]
    return score / K


def top_words(phi: np.ndarray, k: int, n: int = 10) -> np.ndarray:
    """Indices of the n most probable words of topic k."""
    return np.argsort(-np.asarray(phi)[:, k])[:n]
