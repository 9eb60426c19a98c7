"""The numbers that decide `correct`, from the program's readings and the
reference's.

Training (the first steps the set-up drives through the window's own
call): each step's loss; the first gradient as SGD applied it, worked out
from each side's state after one step, (theta0 - theta1) / lr; and the
change of the parameters after the steps, theta3 - theta0. Each tower
parameter is a leaf. A gap is taken by the worst leaf: the distance
between the program's norm and the reference's, over the reference's
norm of that leaf or of the median leaf, whichever is larger. Leaves
whose reference gradient is under a thousandth of the median leaf's are
left out.

The table's rows are compared apart, by the norm of the difference of
the rows after the steps over the norm of the reference's change: a
step moves a row by -lr * g, some 1e-7 an element against rows of some
1e-2, so the norms of the rows would read their values, not the update.

Scoring: the widest gap between a served probability and the
reference's.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

TINY_LEAF = 1e-3


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.to(torch.float64)))


def _f64(leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", torch.float64) for k, v in leaves.items()}


def _worst(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
           keys) -> float:
    ref_n = {k: _norm(ref[k]) for k in keys}
    med = statistics.median(ref_n.values())
    return max(abs(_norm(prog[k]) - ref_n[k]) / max(ref_n[k], med, 1e-300)
               for k in keys)


def loss_gap(losses_p: List[float], losses_r: List[float]) -> float:
    """The widest relative gap of a step's loss."""
    return max(abs(a - b) / abs(b) for a, b in zip(losses_p, losses_r))


def change_gap(theta0, prog, ref) -> float:
    """The worst leaf's gap of the norms of the change from `theta0`."""
    t0, p, r = (_f64(x) for x in (theta0, prog, ref))
    return _worst({k: p[k] - t0[k] for k in t0},
                  {k: r[k] - t0[k] for k in t0}, list(t0))


def training(losses_p: List[float], losses_r: List[float],
             theta0: Dict[str, torch.Tensor], prog1, prog3, ref1, ref3,
             lr: float) -> Dict[str, float]:
    """{loss_gap, grad_gap, change_gap, rows_gap}, and beside them, read
    and not compared: the table's own grad and change gaps, diff_gap (the
    worst tower leaf's norm of the difference of the states after the
    steps over its reference change) and the leaves left out."""
    t0, p1, p3, r1, r3 = (_f64(x) for x in (theta0, prog1, prog3, ref1,
                                             ref3))
    g_p = {k: (t0[k] - p1[k]) / lr for k in t0}
    g_r = {k: (t0[k] - r1[k]) / lr for k in t0}
    d_p = {k: p3[k] - t0[k] for k in t0}
    d_r = {k: r3[k] - t0[k] for k in t0}
    tower = [k for k in t0 if k != "table"]
    norms = {k: _norm(g_r[k]) for k in tower}
    med = statistics.median(norms.values())
    keys = [k for k in tower if norms[k] >= TINY_LEAF * med]
    d_med = statistics.median(_norm(d_r[k]) for k in keys)
    return {
        "loss_gap": loss_gap(losses_p, losses_r),
        "grad_gap": _worst(g_p, g_r, keys),
        "change_gap": _worst(d_p, d_r, keys),
        "rows_gap": _norm(p3["table"] - r3["table"])
        / max(_norm(d_r["table"]), 1e-300),
        "table_grad_gap": _worst(g_p, g_r, ["table"]),
        "table_change_gap": _worst(d_p, d_r, ["table"]),
        "diff_gap": max(_norm(p3[k] - r3[k]) / max(_norm(d_r[k]), d_med)
                        for k in keys),
        "leaves_left_out": float(len(tower) - len(keys)),
    }


def scoring(prog: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """{score_gap}: the widest gap between served and reference
    probabilities."""
    return {"score_gap": float((prog.to(torch.float64)
                                - ref.to(torch.float64)).abs().max())}
