"""Evaluation metrics (numpy): the port's own copy of `auc_score` and
`accuracy` from `herald_tpu/utils/metrics.py`."""

from __future__ import annotations

import numpy as np


def auc_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """ROC-AUC via the rank statistic (exact, ties averaged)."""
    y_true = np.asarray(y_true).reshape(-1)
    y_score = np.asarray(y_score).reshape(-1)
    pos = y_true > 0.5
    n_pos = int(pos.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty(len(y_score), dtype=np.float64)
    sorted_scores = y_score[order]
    # average ranks for ties
    i = 0
    r = 1.0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and \
                sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        avg = (r + r + (j - i)) / 2.0
        ranks[order[i:j + 1]] = avg
        r += j - i + 1
        i = j + 1
    sum_pos_ranks = ranks[pos].sum()
    return float((sum_pos_ranks - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def accuracy(y_true, y_score, threshold=0.5) -> float:
    y_true = np.asarray(y_true).reshape(-1) > 0.5
    pred = np.asarray(y_score).reshape(-1) > threshold
    return float((pred == y_true).mean())
