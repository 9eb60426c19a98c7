"""The plain engine (`Engine.train_epoch`) over one seeded stream staged
on the card as [steps, B, ...]: no cache and no planner, every step reads
and updates its rows in the table.

Set-up: the stream of 2^samples_log2 samples, the benchmark's weights,
the first `check_steps` steps for the check, then chunks until no step
graph has been captured for `warm_quiet_chunks` chunks. A unit of the
window is one chunk of `steps_per_chunk` steps; the window runs the
stream's batches in order and starts it again at its end.
"""

from __future__ import annotations

import torch

from portbench import checks, program, roofline


class Workload:
    def __init__(self, run):
        from herald_tpu_torch.train.engine import Engine
        self.run = run
        cfg, mix = run.cfg, run.mix
        self.ref = run.reference()
        B, self.F = cfg["batch_size"], cfg["num_sparse"]
        self.B = B
        self.n = 1 << mix["samples_log2"]
        self.n_steps = self.n // B
        with run.span("engine"):
            self.eng = Engine(program.herald_config(cfg),
                              table_rows=cfg["table_rows"],
                              device=run.device)
        with run.span("stream"):
            dense, ids, labels = checks.stream(run, self.n)
            head = ids[:mix["check_steps"] * B].cpu().numpy()
            self.d = dense.view(self.n_steps, B, -1)
            self.s = ids.view(self.n_steps, B, -1)
            self.y = labels.view(self.n_steps, B, 1)
        with run.span("weights"):
            self.state = program.base_state(self.eng, cfg, self.ref,
                                            run.seed)
        self.pos = 0
        self.traced_steps = []      # first step of each traced chunk
        with run.span("check_steps"):
            self.prog = checks.program_steps(self, head, mix["check_steps"])
        with run.span("warm_up"):
            quiet = 0
            while quiet < mix["warm_quiet_chunks"]:
                before = self.captures()
                self._chunk(mix["steps_per_chunk"])
                quiet = quiet + 1 if self.captures() == before else 0
        self.last = None

    def _chunk(self, k):
        if self.pos + k > self.n_steps:
            self.pos = 0
        a = self.pos
        if self.run.recording:
            self.traced_steps.append((a, k))
        with self.run.span("train_epoch"):
            self.state, st = self.eng.train_epoch(
                self.state, self.d[a:a + k], self.s[a:a + k],
                self.y[a:a + k], steps=k)
        self.pos += k
        return st["loss"]

    # -- the check -------------------------------------------------------
    def steps(self, k):
        return self._chunk(k).cpu()

    def snapshot(self, union):
        idx = torch.as_tensor(union, dtype=torch.int64,
                              device=self.state.table.device)
        return {**checks.tower_snapshot(self.state),
                "table": self.state.table[idx].cpu()}

    # -- the window ------------------------------------------------------
    def start(self):
        pass

    def unit(self):
        self.last = self._chunk(self.run.mix["steps_per_chunk"])
        return int(self.last.shape[0])

    def close(self):
        """Wait for the steps run so far: read the last loss back."""
        with self.run.span("readback"):
            if self.last is not None:
                float(self.last[-1])
        return 0

    def captures(self):
        return program.captures(self.eng)

    def counters(self):
        return {}

    def end_to_end(self, window_s, steps):
        return {"train_examples_per_s": steps * self.B / window_s}

    def kernel_work(self):
        cfg = self.run.cfg
        W, n = self.eng.width, self.B * self.F
        tb = self.state.table.element_size()
        work = dict.fromkeys(("k1", "k2", "k3", "k5"), 0)
        for a, k in self.traced_steps:
            for i in range(a, a + k):
                u = int(torch.unique(self.s[i]).numel())
                work["k1"] += roofline.k1_bytes(n, u, W, tb, 4, 4)
                work["k3"] += roofline.k3_bytes(n, u, W, 8)
                work["k2"] += roofline.k2_bytes(n, u, W, tb, 4)
                if cfg["reference"] == "dfm":
                    work["k5"] += roofline.k5_bytes(
                        self.B, self.F, cfg["embedding_dim"], True)
        return work

    def step_flops(self):
        """The tower's forward and backward operations a step."""
        return self.ref.flops(self.run.cfg, self.B, True)

    def free(self):
        del self.state, self.eng, self.d, self.s, self.y

    def judge(self):
        return checks.reference_steps(self.run, self.prog, self.n)
