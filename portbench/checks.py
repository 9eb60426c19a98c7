"""The check of the training cells, both sides of it.

The program's side runs inside the set-up: the state the window trains
is driven from the seed through its first steps by the window's own call
(one step, then the rest), and after the first and the last of them the
tower and the touched rows are read back. The reference's side runs once
the window has closed and the program's state is gone: it makes the
weights and the first batches again from the seed (the step order at one
device is the stream's) and follows the same steps with plain SGD
(`reference/train.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import gen, judge
from portbench.program import DTYPES
from portbench.reference import precision, train


def program_steps(work, stream_ids: np.ndarray, n_steps: int) -> dict:
    """Drive `work` (a training workload: `steps(k)`, `snapshot(ids)`)
    through its first `n_steps` steps: {union, losses, p1, p3}."""
    B = work.run.cfg["batch_size"]
    union = np.unique(np.asarray(stream_ids[:n_steps * B]).reshape(-1))
    losses = [float(x) for x in work.steps(1)]
    p1 = work.snapshot(union)
    losses += [float(x) for x in work.steps(n_steps - 1)]
    return {"union": union, "losses": losses, "p1": p1,
            "p3": work.snapshot(union)}


def stream(run, n: int):
    cfg, mix = run.cfg, run.mix
    return gen.ctr_stream(n, cfg["table_rows"], cfg["num_sparse"],
                          cfg["num_dense"], mix["zipf_a"],
                          mix["dirichlet_alpha"], mix["split_seed"], run.seed,
                          run.device)


def set_tf32(card_tf32: bool) -> None:
    """The library's TF32 off, as the configuration states, or on for the
    card's own TF32 control."""
    precision.no_tf32()
    torch.backends.cuda.matmul.allow_tf32 = card_tf32


def reference_readings(run, union: np.ndarray, n: int, k: int,
                       matmul: str = "float32", half_batch: bool = False,
                       card_tf32: bool = False):
    """The reference's first `k` steps on the stream of `n` samples, over
    the rows `union`: (theta0, losses, leaves after step 1, leaves after
    step k), the leaves being the tower's and "table", the rows."""
    cfg, ref, dev = run.cfg, run.reference(), run.device
    B, lr = cfg["batch_size"], cfg["learning_rate"]
    union = torch.as_tensor(union, dtype=torch.int64, device=dev)
    rows0 = gen.table_rows(union, cfg["table_rows"], ref.width(cfg),
                           DTYPES[cfg["table_dtype"]], run.seed)
    tower0 = gen.tower(ref.shapes(cfg), cfg["tower"]["init_std"], run.seed,
                       dev)
    dense, ids, labels = stream(run, n)
    batches = [train.Batch(dense[i * B:(i + 1) * B], ids[i * B:(i + 1) * B],
                           labels[i * B:(i + 1) * B]) for i in range(k)]
    del dense, ids, labels
    set_tf32(card_tf32)
    states, losses = train.run(ref, train.State(tower0, union, rows0),
                               batches, lr, precision.MATMUL[matmul],
                               half_batch)

    def leaves(s):
        return {**s.tower, "table": s.rows}
    return ({**tower0, "table": rows0}, losses, leaves(states[0]),
            leaves(states[-1]))


def reference_steps(run, prog: dict, n: int) -> dict:
    """The judge's numbers: the program's readings `prog` against the
    reference's of the same steps."""
    theta0, losses, r1, r3 = reference_readings(
        run, prog["union"], n, len(prog["losses"]))
    return judge.training(prog["losses"], losses, theta0, prog["p1"],
                          prog["p3"], r1, r3, run.cfg["learning_rate"])


def reference_scores(run, dense: np.ndarray, ids: np.ndarray,
                     matmul: str = "float32", card_tf32: bool = False):
    """The reference's probabilities of requests `dense` [k, R, ND],
    `ids` [k, R, F] (host arrays), one request at a time: [k, R]."""
    cfg, ref, dev = run.cfg, run.reference(), run.device
    ids = torch.as_tensor(ids, device=dev).long()
    dense = torch.as_tensor(dense, device=dev)
    union, pos = torch.unique(ids, return_inverse=True)
    rows = gen.table_rows(union, cfg["table_rows"], ref.width(cfg),
                          DTYPES[cfg["table_dtype"]], run.seed)
    tower = gen.tower(ref.shapes(cfg), cfg["tower"]["init_std"], run.seed,
                      dev)
    set_tf32(card_tf32)
    with torch.no_grad():
        return torch.stack([torch.sigmoid(ref.logits(
            tower, rows[pos[j]].to(torch.float32), dense[j],
            precision.MATMUL[matmul])) for j in range(ids.shape[0])])


def _events(st: dict):
    """The churned steps' programs as events of each id, in order (a
    step's flushes before its batch): {id: [(kind, slot), ...]}, kind "f"
    a flush, "p" a use the program pulls, "h" a use it reads from its
    slot."""
    (_, slots, pulls, fids, fslots, _, _, uniq, _) = st["arrays"]
    R = st["R"]
    events = {}
    for k in range(slots.shape[0]):
        ok = (fids[k] >= 0) & (fids[k] < R)
        for x, s in zip(fids[k][ok].tolist(), fslots[k][ok].tolist()):
            events.setdefault(x, []).append(("f", s))
        ok = uniq[k] >= 0
        for x, s, p in zip(uniq[k][ok].tolist(), slots[k][ok].tolist(),
                           pulls[k][ok].tolist()):
            events.setdefault(x, []).append(("p" if p else "h", s))
    return events


def churned_steps(run, st: dict, n: int) -> dict:
    """The churned steps after the window (`drivers/sched.py`), judged by
    plain SGD and by the table, so that a planner's fault cannot hide in
    its own decisions.

    The reference takes each step's batch from the stream, at its place
    in stream order, and runs plain SGD (`reference/train.py`, no cache)
    from the rows as the program held them before the steps: for an id
    whose first event is a flush or a read from its slot, that slot's
    value, else its table row. The programs only say where to read. Every
    slot read so is held to the table: a slot that holds id x has
    value = table[x] - lr * delta (a pull copies the row with delta 0, a
    use moves both planes, a flush moves the row and zeroes delta), which
    a slot holding another id, or a delta flushed elsewhere, breaks by
    the rows' own scale.

    {stage_loss_gap, stage_change_gap (the tower), stage_rows_gap (the
    rows as the program holds them after the steps, from the slot of an
    id's last use or the table after its last flush, against the
    reference: norm of the difference over the reference's change),
    stage_held_gap (the worst slot read before or after the steps:
    |value - (table[x] - lr * delta)| over |table[x]|), stage_flush_gap
    (ids the steps only flush: the table row after against the slot's
    value before, over the move the flush had to make, lr * delta)}, and
    beside them, read and not compared, the counts of the events and of
    the steps whose distinct ids are not the stream's."""
    cfg, dev = run.cfg, run.device
    lr, B = cfg["learning_rate"], cfg["batch_size"]
    ids, held = st["ids"], st["slots"]
    before, after = st["before"], st["after"]
    t0, c0 = before["table"].double(), before["cache"].double()
    t1, c1 = after["table"].double(), after["cache"].double()
    W = t0.shape[1]
    events = _events(st)
    K = st["arrays"][1].shape[0]
    at = [(st["at"] + j) % st["steps_per_epoch"] for j in range(K)]
    dense, sids, labels = stream(run, n)
    batches = [train.Batch(dense[p * B:(p + 1) * B], sids[p * B:(p + 1) * B],
                           labels[p * B:(p + 1) * B]) for p in at]
    del dense, labels
    uniq = st["arrays"][7]
    off = sum(not np.array_equal(
        np.unique(b.ids.cpu().numpy()), np.sort(uniq[k][uniq[k] >= 0]))
        for k, b in enumerate(batches))

    def at_id(x):
        return torch.as_tensor(np.searchsorted(ids, x), dtype=torch.int64)

    def at_slot(s):
        s = np.asarray(s, np.int64)
        j = np.minimum(np.searchsorted(held, s), len(held) - 1)
        if not np.array_equal(held[j], s):
            raise ValueError("a program names a slot outside the cache")
        return torch.as_tensor(j, dtype=torch.int64)

    def pairs(which, kinds):
        xs = [x for x, e in events.items() if which(e)[0] in kinds]
        return xs, [which(events[x])[1] for x in xs]

    def held_gap(t, c, xs, ss):
        if not xs:
            return 0.0
        i, j = at_id(xs), at_slot(ss)
        r = c[j, :W] - (t[i] - lr * c[j, W:])
        return float((torch.linalg.vector_norm(r, dim=1)
                      / torch.linalg.vector_norm(t[i], dim=1)).max())

    def rel(a, b):
        return float(torch.linalg.vector_norm(a)
                     / max(float(torch.linalg.vector_norm(b)), 1e-300))

    # the rows before: the slot of a first flush or read, else the table
    rows0 = t0.clone()
    xs_b, ss_b = pairs(lambda e: e[0], "fh")
    if xs_b:
        rows0[at_id(xs_b)] = c0[at_slot(ss_b), :W]
    # the program's rows after: the slot of a last use, else the table
    rows1 = t1.clone()
    xs_a, ss_a = pairs(lambda e: e[-1], "ph")
    if xs_a:
        rows1[at_id(xs_a)] = c1[at_slot(ss_a), :W]
    xs_f = [x for x, e in events.items() if len(e) == 1 and e[0][0] == "f"]
    ss_f = [events[x][0][1] for x in xs_f]

    set_tf32(False)
    tower0 = {k: v.to(dev) for k, v in before["tower"].items()}
    states, losses = train.run(
        run.reference(), train.State(tower0, torch.as_tensor(
            ids, device=dev).long(), rows0.to(dev, torch.float32)),
        batches, lr, precision.MATMUL["float32"])
    ref1 = states[-1].rows.cpu().double()
    keep = torch.ones(len(ids), dtype=torch.bool)
    flush_gap = 0.0
    if xs_f:
        i, j = at_id(xs_f), at_slot(ss_f)
        keep[i] = False
        flush_gap = rel(t1[i] - c0[j, :W], lr * c0[j, W:])
    kinds = [k for e in events.values() for k, _ in e]
    return {
        "stage_loss_gap": judge.loss_gap(st["losses"], losses),
        "stage_change_gap": judge.change_gap(
            before["tower"], after["tower"],
            {k: v.cpu() for k, v in states[-1].tower.items()}),
        "stage_rows_gap": rel(rows1[keep] - ref1[keep],
                              ref1[keep] - rows0[keep]),
        "stage_held_gap": max(held_gap(t0, c0, xs_b, ss_b),
                              held_gap(t1, c1, xs_a, ss_a)),
        "stage_flush_gap": flush_gap,
        "stage_flushes": float(kinds.count("f")),
        "stage_pulls": float(kinds.count("p")),
        "stage_reads": float(kinds.count("h")),
        "stage_flushed_only": float(len(xs_f)),
        "stage_steps_off_stream": float(off),
    }


def tower_snapshot(state) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in
            state.dense.items()}
