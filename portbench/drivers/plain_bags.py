"""The plain engine (`Engine.train_epoch`) on a multi-hot model
(DLRM-DCNv2): a seeded stream of samples that each read a bag of ids from
every table, staged on the card as [steps, B, P] and replayed in order,
as `drivers/plain.py` runs the one-hot stream. Every step reads its bags
through K1's pooled form, dedups its B * P ids, sums their gradients
through K3 and adds them through K2.

The stream (`multihot_stream`): table t owns rows [offset_t, offset_t +
rows_t) of one table (the configuration's `rows_per_table`); each of its
`multi_hot_sizes[t]` positions draws a Zipf id over the table's rows (the
zeta distribution folded into them, as `gen.ctr_stream` folds a field's);
dense features are standard normals and labels come from a hidden linear
model over them and hashed id signs. The weights are the benchmark's:
the table from `gen.fill_table`, the tower from `gen.tower` at std 1 and
each leaf scaled by the reference's `init_std`.

Set-up, window and check are `drivers/plain.py`'s (its `Workload`, with
its span names, on this stream and these weights); the check (`judge`)
runs the same first `check_steps` steps through `reference/train.py`
over this stream, and `reference_readings` serves the controls
(`portbench/control_bags.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import checks, gen, judge, program, roofline
from portbench.drivers import plain
from portbench.program import DTYPES
from portbench.reference import precision, train


def table_offsets(cfg: dict) -> np.ndarray:
    """Each table's first row in the one table; raises unless the tables'
    rows add up to `table_rows` and each has a bag."""
    rows = np.asarray(cfg["rows_per_table"], np.int64)
    if int(rows.sum()) != cfg["table_rows"] \
            or rows.size != len(cfg["multi_hot_sizes"]):
        raise ValueError(f"rows_per_table sums to {int(rows.sum())} over "
                         f"{rows.size} tables; table_rows is "
                         f"{cfg['table_rows']} over "
                         f"{len(cfg['multi_hot_sizes'])} bags")
    return np.concatenate([[0], np.cumsum(rows)[:-1]])


def multihot_stream(cfg: dict, zipf_a: float, n: int, seed: int, device):
    """(dense f32 [n, num_dense], ids int32 [n, P], labels f32 [n, 1]) on
    `device`, every draw from `seed`."""
    g = gen.generator(seed, gen.STREAM, device)
    offsets = table_offsets(cfg)
    bags = cfg["multi_hot_sizes"]
    ids = torch.empty((n, sum(bags)), dtype=torch.int32, device=device)
    id_sign = torch.zeros(n, dtype=torch.float64, device=device)
    p = 0
    for t, bag in enumerate(bags):
        raw = gen.zeta(g, zipf_a, (n, bag), device)
        part = torch.fmod(raw - 1.0, float(cfg["rows_per_table"][t])).long() \
            + int(offsets[t])
        del raw
        ids[:, p:p + bag] = part.to(torch.int32)
        id_sign += ((part * 2654435761) % 97 / 48.0 - 1.0).sum(dim=1)
        del part
        p += bag
    id_sign /= p
    nd = cfg["num_dense"]
    dense = torch.randn((n, nd), generator=g, device=device)
    w = torch.randn(nd, generator=g, device=device)
    # elementwise, so the labels do not depend on the matmul precision
    logits = (dense * w).sum(dim=1) + 2.0 * id_sign.to(torch.float32) \
        + 0.1 * torch.randn(n, generator=g, device=device)
    labels = (logits > logits.median()).to(torch.float32).view(n, 1)
    return dense, ids, labels


def tower(ref, cfg: dict, seed: int, device) -> dict:
    """The benchmark's tower: `gen.tower` at std 1, each leaf times the
    reference's `init_std`."""
    std = ref.init_std(cfg)
    return {k: v.mul_(std[k]) for k, v in
            gen.tower(ref.shapes(cfg), 1.0, seed, device).items()}


class _Model:
    """The reference model over the configuration's bags, as
    `reference/train.py` calls a model."""

    def __init__(self, ref, bags):
        self.ref, self.bags = ref, tuple(bags)

    def logits(self, p, emb, dense, mm):
        return self.ref.logits(p, emb, dense, mm, bags=self.bags)


def reference_readings(run, union: np.ndarray, n: int, k: int,
                       matmul: str = "float32", half_batch: bool = False,
                       card_tf32: bool = False):
    """`checks.reference_readings` over this stream: (theta0, losses,
    leaves after step 1, leaves after step k)."""
    cfg, ref, dev = run.cfg, run.reference(), run.device
    B, lr = cfg["batch_size"], cfg["learning_rate"]
    union = torch.as_tensor(union, dtype=torch.int64, device=dev)
    rows0 = gen.table_rows(union, cfg["table_rows"], ref.width(cfg),
                           DTYPES[cfg["table_dtype"]], run.seed)
    tower0 = tower(ref, cfg, run.seed, dev)
    dense, ids, labels = multihot_stream(cfg, run.mix["zipf_a"], n,
                                         run.seed, dev)
    batches = [train.Batch(dense[i * B:(i + 1) * B], ids[i * B:(i + 1) * B],
                           labels[i * B:(i + 1) * B]) for i in range(k)]
    del dense, ids, labels
    checks.set_tf32(card_tf32)
    states, losses = train.run(_Model(ref, cfg["multi_hot_sizes"]),
                               train.State(tower0, union, rows0), batches,
                               lr, precision.MATMUL[matmul], half_batch)

    def leaves(s):
        return {**s.tower, "table": s.rows}
    return ({**tower0, "table": rows0}, losses, leaves(states[0]),
            leaves(states[-1]))


class Workload(plain.Workload):
    """`drivers/plain.py`'s workload on the multi-hot stream and weights,
    with this cell's kernel bytes and judge."""

    def __init__(self, run):
        from herald_tpu_torch.train.engine import Engine
        self.run = run
        cfg, mix = run.cfg, run.mix
        self.ref = run.reference()
        self.B = B = cfg["batch_size"]
        self.n = 1 << mix["samples_log2"]
        self.n_steps = self.n // B
        with run.span("engine"):
            self.eng = Engine(program.herald_config(cfg),
                              table_rows=cfg["table_rows"],
                              device=run.device)
        with run.span("stream"):
            dense, ids, labels = multihot_stream(cfg, mix["zipf_a"], self.n,
                                                 run.seed, run.device)
            head = ids[:mix["check_steps"] * B].cpu().numpy()
            self.d = dense.view(self.n_steps, B, -1)
            self.s = ids.view(self.n_steps, B, -1)
            self.y = labels.view(self.n_steps, B, 1)
        with run.span("weights"):
            self.state = program.base_state(
                self.eng, {**cfg, "tower": {**cfg["tower"], "init_std": 1.0}},
                self.ref, run.seed)
            std = self.ref.init_std(cfg)
            for k, v in self.state.dense.items():
                v.mul_(std[k])
        self.pos = 0
        self.traced_steps = []      # first step and length of traced chunks
        with run.span("check_steps"):
            self.prog = checks.program_steps(self, head, mix["check_steps"])
        with run.span("warm_up"):
            quiet = 0
            while quiet < mix["warm_quiet_chunks"]:
                before = self.captures()
                self._chunk(mix["steps_per_chunk"])
                quiet = quiet + 1 if self.captures() == before else 0
        self.last = None

    def kernel_work(self):
        """Bytes each kernel's launches need over the traced steps, as
        this cell's calls make them (`roofline.py`'s rule): the pooled
        read ("k1_bag") reads each distinct row once, the ids and the bag
        offsets once, and writes [B, bags, W] f32; K3 through its map
        reads the int64 inverse, the int32 map and the pooled gradient
        [B, bags, W] once, and writes each distinct row's sum; K2 as the
        one-hot cells."""
        cfg = self.run.cfg
        W, B = self.eng.width, self.B
        n = B * sum(cfg["multi_hot_sizes"])
        pooled = B * len(cfg["multi_hot_sizes"]) * W * 4
        tb = self.state.table.element_size()
        work = dict.fromkeys(("k1_bag", "k2", "k3"), 0)
        for a, k in self.traced_steps:
            for i in range(a, a + k):
                u = int(torch.unique(self.s[i]).numel())
                work["k1_bag"] += u * W * tb + n * 4 + pooled \
                    + 4 * (len(cfg["multi_hot_sizes"]) + 1)
                work["k3"] += n * 8 + n * 4 + pooled + u * W * 4
                work["k2"] += roofline.k2_bytes(n, u, W, tb, 4)
        return work

    def judge(self):
        theta0, losses, r1, r3 = reference_readings(
            self.run, self.prog["union"], self.n, len(self.prog["losses"]))
        return judge.training(self.prog["losses"], losses, theta0,
                              self.prog["p1"], self.prog["p3"], r1, r3,
                              self.run.cfg["learning_rate"])
