"""The port's metrics (`herald_tpu_torch/utils/metrics.py`) equal
`herald_tpu/utils/metrics.py`'s outputs exactly on the same arrays, NaN
scores and ties included, and on tests/test_metrics.py's cases."""

import numpy as np
import pytest

from herald_tpu.utils import metrics as JM
from herald_tpu_torch.utils import metrics as M


def _cases():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 500).astype(float)
    p = np.clip(rng.normal(0.5 + 0.2 * (y - 0.5), 0.25), 0, 1)
    nan = p.copy()
    nan[rng.random(500) < 0.1] = np.nan
    return {
        "fixture": (y, p),        # tests/test_metrics.py's seed-0 fixture
        "nan": (y, nan),
        "ties": (y, np.round(p, 1)),
        "one-class": (np.ones(50), rng.random(50)),
        "small-nan": (np.array([1, 1, 0, 0, 1], float),
                      np.array([0.9, np.nan, 0.1, np.nan, 0.8])),
    }


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_metrics_equal_jax(case):
    y, p = CASES[case]
    for curve in ("ROC", "PR"):
        for t in (5, 200):
            for a, b in zip(M.roc_pr_curve(y, p, t, curve),
                            JM.roc_pr_curve(y, p, t, curve)):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
            assert M.auc_riemann(y, p, t, curve) == \
                JM.auc_riemann(y, p, t, curve)
    for thr in (0.3, 0.5):
        np.testing.assert_array_equal(M.confusion_matrix(y, p, thr),
                                      JM.confusion_matrix(y, p, thr))
        assert M.precision_recall_f1(y, p, thr) == \
            JM.precision_recall_f1(y, p, thr)
        assert M.accuracy(y, p, thr) == JM.accuracy(y, p, thr)
    if not np.isnan(p).any():
        assert M.auc_score(y, p) == JM.auc_score(y, p)


def test_metric_values():
    """tests/test_metrics.py's oracles."""
    y = np.array([1, 1, 0, 0])
    s = np.array([0.9, 0.2, 0.8, 0.1])
    assert M.confusion_matrix(y, s).tolist() == [[1, 1], [1, 1]]
    assert M.precision_recall_f1(y, s) == (0.5, 0.5, 0.5)
    y, p = CASES["fixture"]
    np.testing.assert_allclose(M.auc_riemann(y, p, curve="ROC"), 0.676913,
                               atol=1e-5)
    assert abs(M.auc_riemann(y, p) - M.auc_score(y, p)) < 5e-3
    x, r = M.roc_pr_curve(y, p, curve="ROC")
    np.testing.assert_allclose([x[0], r[0]], [1.0, 1.0], atol=1e-5)
    assert (np.diff(x) <= 1e-12).all() and (np.diff(r) <= 1e-12).all()
    # NaN scores are predicted negative at every threshold
    x, r = M.roc_pr_curve(*CASES["small-nan"], num_thresholds=5)
    np.testing.assert_allclose([r[0], x[0]], [2 / 3, 1 / 2], rtol=1e-5)
