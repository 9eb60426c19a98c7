"""Scoring requests that arrive at a fixed rate, `rate_per_s` (open
loop, evenly spaced, the same for every seed), served one at a time by
one caller: each request is `rows_per_request` rows drawn by the stream's
generator, handed to `Engine.predict` as host arrays, its scores read
back to the host. A request's time runs from when it was due to the
scores on the host, so a request that waits behind a slow one counts
its wait.

Set-up: a pool of `pool_requests` requests (the window cycles through
it), the benchmark's weights, then requests until no step graph has been
captured for `warm_quiet_requests` requests. A unit of the window is one
request. The check scores `checked_requests` of the window's requests,
drawn from the seed, again with the reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import checks, gen, judge, program, roofline


class Workload:
    def __init__(self, run):
        from herald_tpu_torch.train.engine import Engine
        self.run = run
        cfg, mix = run.cfg, run.mix
        self.ref = run.reference()
        self.R, self.F = mix["rows_per_request"], cfg["num_sparse"]
        self.pool = mix["pool_requests"]
        with run.span("engine"):
            self.eng = Engine(program.herald_config(cfg, self.R),
                              table_rows=cfg["table_rows"],
                              device=run.device)
        with run.span("requests"):
            dense, ids, _ = checks.stream(run, self.pool * self.R)
            self.d = dense.cpu().numpy().reshape(self.pool, self.R, -1)
            self.s = ids.cpu().numpy().reshape(self.pool, self.R, -1)
            del dense, ids
        with run.span("weights"):
            self.state = program.base_state(self.eng, cfg, self.ref,
                                            run.seed)
        # requests due in the window, and those the check keeps (drawn
        # from the seed): no list grows with the window's requests, so the
        # collector's pauses do not grow with it either
        self.due_n = int(mix["rate_per_s"] * run.seconds)
        rng = np.random.default_rng(gen.sub_seed(run.seed, gen.SAMPLE))
        self.checked = set(rng.choice(
            self.due_n, size=min(mix["checked_requests"], self.due_n),
            replace=False).tolist())
        self.latency = np.zeros(self.due_n + mix["warm_quiet_requests"]
                                + 1024)
        self.count = self.late = 0
        self.t0 = None      # the window's first arrival; None: no schedule
        self.scores, self.traced = {}, []
        with run.span("warm_up"):
            quiet = 0
            while quiet < mix["warm_quiet_requests"]:
                before = self.captures()
                self.unit()
                quiet = quiet + 1 if self.captures() == before else 0
        self.count = self.late = 0      # late: started after their due time
        self.scores = {}

    def _due(self):
        """Wait for the next request's arrival: its due time."""
        if self.t0 is None:
            return time.perf_counter()
        due = self.t0 + self.count / self.run.mix["rate_per_s"]
        now = time.perf_counter()
        if now > due:
            self.late += 1
        while now < due:
            if due - now > 2e-3:
                time.sleep(due - now - 1e-3)
            now = time.perf_counter()
        return due

    def unit(self):
        r = self.count % self.pool
        if self.run.recording:
            self.traced.append(r)
        t = self._due()
        with self.run.span("predict"):
            p = self.eng.predict(self.state, self.d[r], self.s[r])
        with self.run.span("readback"):
            p = p.cpu().numpy()
        self.latency[self.count] = time.perf_counter() - t
        if self.count in self.checked:
            self.scores[self.count] = p
        self.count += 1
        return 1

    def close(self):
        """At the window's end, serve what was due in it and is not yet
        served (late, and timed from when it was due)."""
        if self.t0 is None or \
                time.perf_counter() < self.t0 + self.run.seconds:
            return 0
        n = 0
        while self.count < self.due_n:
            n += self.unit()
        return n

    def start(self):
        """The window opens: requests arrive from now on."""
        self.t0 = time.perf_counter()

    def captures(self):
        return program.captures(self.eng)

    def counters(self):
        return {}

    def end_to_end(self, window_s, requests):
        lat = self.latency[:self.count]
        return {"score_ms_p95": float(np.percentile(lat, 95)) * 1e3,
                "scored_examples_per_s": requests * self.R / window_s,
                "score_ms_median": float(np.median(lat)) * 1e3,
                "late_requests": self.late}

    def kernel_work(self):
        cfg = self.run.cfg
        W, n = self.eng.width, self.R * self.F
        tb = self.state.table.element_size()
        work = dict.fromkeys(("k1", "k5"), 0)
        for r in self.traced:
            u = int(np.unique(self.s[r]).size)
            work["k1"] += roofline.k1_bytes(n, u, W, tb, 4, 4)
            if cfg["reference"] == "dfm":
                work["k5"] += roofline.k5_bytes(self.R, self.F,
                                                cfg["embedding_dim"], False)
        return work

    def step_flops(self):
        """The tower's forward operations a request."""
        return self.ref.flops(self.run.cfg, self.R, False)

    def free(self):
        del self.state, self.eng

    def judge(self):
        which = sorted(self.scores)
        picked = [i % self.pool for i in which]
        prog = torch.as_tensor(np.stack([self.scores[i] for i in which]))
        return judge.scoring(prog, checks.reference_scores(
            self.run, self.d[picked], self.s[picked]).cpu())
