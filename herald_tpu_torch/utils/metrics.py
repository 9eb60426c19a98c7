"""Evaluation metrics (numpy): the port's own copy of
`herald_tpu/utils/metrics.py`, mirroring `python/hetu/metrics.py`:
ROC/AUC, the discretized ROC and PR curves, confusion matrix, accuracy,
precision/recall/F1."""

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


def roc_pr_curve(y_true, y_score, num_thresholds: int = 200,
                 curve: str = "ROC"):
    """Discretized ROC or PR curve arrays (x_axis, y_axis).

    Mirrors the reference `roc_pr_curve`/`auc` pair
    (`python/hetu/metrics.py:120-154`): `num_thresholds` evenly-spaced
    thresholds over [0, 1] with +/- epsilon end caps; ROC returns
    (fp_rate, recall), PR returns (recall, precision). The vectorized
    confusion counts replace the reference's per-threshold python loop.
    """
    eps = 1e-7
    y_true = np.asarray(y_true).reshape(-1) > 0.5
    y_score = np.asarray(y_score).reshape(-1).astype(np.float64)
    thr = np.concatenate([
        [-eps],
        (np.arange(1, num_thresholds - 1) / (num_thresholds - 1)),
        [1.0 + eps]])
    # tp(t) = #positives with score > t, via one sort + searchsorted —
    # O(N log N) time, O(N) memory (a [T, N] comparison matrix would be
    # ~1 GB at Criteo validation scale). NaN scores compare False against
    # every threshold (predicted negative), matching the elementwise
    # formulation — sorted NaNs land at the tail and would otherwise be
    # counted positive, so drop them from the score arrays (they still
    # count in n_pos/n_neg -> fn/tn, as before).
    pos_scores = np.sort(y_score[y_true & np.isfinite(y_score)])
    neg_scores = np.sort(y_score[~y_true & np.isfinite(y_score)])
    tp = (len(pos_scores)
          - np.searchsorted(pos_scores, thr, side="right")).astype(
        np.float64)
    fp = (len(neg_scores)
          - np.searchsorted(neg_scores, thr, side="right")).astype(
        np.float64)
    n_pos = float(y_true.sum())
    n_neg = float(len(y_true) - n_pos)
    fn = n_pos - tp
    tn = n_neg - fp
    rec = (tp + eps) / (tp + fn + eps)
    if curve.upper() == "ROC":
        return (fp + eps) / (fp + tn + eps), rec
    prec = (tp + eps) / (tp + fp + eps)
    return rec, prec


def auc_riemann(y_true, y_score, num_thresholds: int = 200,
                curve: str = "ROC") -> float:
    """Approximate AUC via the trapezoid sum over `roc_pr_curve`
    (reference `metrics.py auc`); `auc_score` above is the exact
    rank-statistic ROC-AUC."""
    x, y = roc_pr_curve(y_true, y_score, num_thresholds, curve)
    return float(np.sum((x[:-1] - x[1:]) * (y[:-1] + y[1:]) / 2.0))


def accuracy(y_true, y_score, threshold=0.5) -> float:
    y_true = np.asarray(y_true).reshape(-1) > 0.5
    pred = np.asarray(y_score).reshape(-1) > threshold
    return float((pred == y_true).mean())


def confusion_matrix(y_true, y_score, threshold=0.5):
    y_true = np.asarray(y_true).reshape(-1) > 0.5
    pred = np.asarray(y_score).reshape(-1) > threshold
    tp = int(np.sum(pred & y_true))
    fp = int(np.sum(pred & ~y_true))
    fn = int(np.sum(~pred & y_true))
    tn = int(np.sum(~pred & ~y_true))
    return np.array([[tn, fp], [fn, tp]])


def precision_recall_f1(y_true, y_score, threshold=0.5):
    (_, fp), (fn, tp) = confusion_matrix(y_true, y_score, threshold)
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return precision, recall, f1
