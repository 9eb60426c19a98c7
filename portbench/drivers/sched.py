"""The scheduled, cached engine with its live planner (`CachedEngine`,
`CachePlanner`) over one seeded stream staged on the card.

Set-up: the stream of 2^samples_log2 samples (its distinct ids counted
against the cache's rows), its dense features and labels staged with
`stage_dataset`, the benchmark's weights, a planner at the launcher's
defaults for `epochs` epochs in stream order, the first `check_steps`
steps for the check, then chunks until the planner evicts dirty rows (the
cache is full) and no step graph has been captured for
`warm_quiet_chunks` chunks. A unit of the window is one chunk of
`steps_per_chunk` steps through `train_epoch_cached`. Once the window has
closed, `check_steps` more steps through the same call, on the churning
cache, with the rows and slots they name read before and after them
(`checks.churned_steps` judges them).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import checks, program, roofline

COUNTERS = ("miss_pull", "miss_push", "update_pull", "update_push")


class Workload:
    def __init__(self, run):
        from herald_tpu_torch.train.cached import CachedEngine
        self.run = run
        cfg, mix = run.cfg, run.mix
        self.ref = run.reference()
        self.B, self.F = cfg["batch_size"], cfg["num_sparse"]
        self.n = 1 << mix["samples_log2"]
        self.steps_per_epoch = self.n // self.B
        with run.span("engine"):
            self.eng = eng = CachedEngine(program.herald_config(cfg),
                                          table_rows=cfg["table_rows"],
                                          device=run.device)
        with run.span("stream"):
            dense, ids, labels = checks.stream(run, self.n)
            self.distinct = int(torch.unique(ids).numel())
            self.ids = ids.cpu().numpy()
            self.device_data = eng.stage_dataset(dense.cpu().numpy(), None,
                                                 labels.cpu().numpy())
            del dense, ids, labels
        print(f"stream: {self.n} samples, {self.distinct} distinct ids, "
              f"{self.distinct / eng.cache_rows:.4f} x the cache's "
              f"{eng.cache_rows} rows", file=run.err)
        with run.span("weights"):
            self.state = program.cached_state(eng, cfg, self.ref, run.seed)
        with run.span("planner"):
            self.planner = eng.make_planner(
                self.ids, epochs=mix["epochs"],
                n_threads=mix["planner_threads"])
        self._pop = self.planner.pop_chunk
        self.planner.pop_chunk = self._timed_pop
        self.popped_steps = 0   # programs popped so far
        self.popped = []        # the programs popped while recording
        self.slot_of = {}       # id -> cache slot, while tracking
        self.tracking = True
        self.stage = None       # the churned steps' readings, after the window
        with run.span("check_steps"):
            self.prog = checks.program_steps(self, self.ids,
                                             mix["check_steps"])
        self.tracking = False
        assign = [row for p in self.popped for row in p[0]]
        self.popped = []
        self.stream_order = all(
            np.array_equal(a, np.arange(i * self.B, (i + 1) * self.B))
            for i, a in enumerate(assign))
        with run.span("warm_up"):
            self._warm(mix)
        self.last = None

    # -- the program's calls ---------------------------------------------
    def _timed_pop(self, steps):
        with self.run.span("pop_chunk"):
            out = self._pop(steps)
        K = out[0]
        if K and (self.run.recording or self.tracking):
            self.popped.append([np.array(a[:K]) for a in out[1:]])
        if K and self.tracking:
            for uniq, slots in zip(out[8][:K], out[2][:K]):
                ok = uniq >= 0
                self.slot_of.update(zip(uniq[ok].tolist(),
                                        slots[ok].tolist()))
        if K and self.stage is not None:
            self._stage_before(self.popped_steps,
                               [np.array(a[:K]) for a in out[1:]])
        self.popped_steps += K
        return out

    def _chunk(self, steps):
        with self.run.span("train_epoch_cached"):
            self.state, st = self.eng.train_epoch_cached(
                self.state, self.planner, None, None, None, steps=steps,
                device_data=self.device_data)
        if st is None:
            raise RuntimeError("the planner's stream ended: raise the "
                               "mix's epochs")
        return st["loss"]

    def _warm(self, mix):
        C = mix["steps_per_chunk"]
        for _ in range(mix["max_warm_chunks"]):
            if self.planner.perf()["miss_push"] > 0:
                break
            self._chunk(C)
        else:
            raise RuntimeError("the cache never filled in the warm-up")
        quiet = 0
        while quiet < mix["warm_quiet_chunks"]:
            before = self.captures()
            self._chunk(C)
            quiet = quiet + 1 if self.captures() == before else 0

    # -- the check -------------------------------------------------------
    def steps(self, k):
        return self._chunk(k).cpu()

    def snapshot(self, union):
        """The tower, and the rows of `union` as the program holds them:
        the cache's value plane for the rows it has taken in, the table
        for the rest."""
        W = self.eng.width
        table = self.state.table
        idx = torch.as_tensor(union, dtype=torch.int64, device=table.device)
        rows = table[idx].clone()
        have = [(i, self.slot_of[int(x)]) for i, x in enumerate(union)
                if int(x) in self.slot_of]
        if have:
            pos = torch.as_tensor([i for i, _ in have], device=table.device)
            slot = torch.as_tensor([s for _, s in have], device=table.device)
            rows[pos] = self.state.cache[slot, :W].to(table.dtype)
        return {**checks.tower_snapshot(self.state), "table": rows.cpu()}

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
        p = self.planner.perf()
        return {k: p[k] for k in COUNTERS}

    def end_to_end(self, window_s, steps):
        return {"train_examples_per_s": steps * self.B / window_s}

    def kernel_work(self):
        """Bytes each kernel needs over the traced chunks, from the
        programs they ran, and the tower's operations."""
        eng, cfg = self.eng, self.run.cfg
        W, U, C = eng.width, eng.U_cap, eng.cache_rows
        R, n = eng.padded_rows, self.B * self.F
        tb = self.state.table.element_size()
        work = dict.fromkeys(("k1", "k3", "k5"), 0)
        for (assign, slots, pulls, fids, fslots, pfids, _, uniq,
             inv) in self.popped:
            for k in range(len(assign)):
                Fc = fids.shape[1]
                ft = (fids[k] >= 0) & (fids[k] < R)
                fc = (fslots[k] >= 0) & (fslots[k] < C)
                if ft.any() or fc.any():
                    work["k1"] += roofline.k1_bytes(
                        Fc, roofline.distinct(fslots[k], 0, C), 2 * W, 4, 4,
                        4)
                    work["k1"] += roofline.k1_bytes(
                        Fc, roofline.distinct(fids[k], 0, R), W, tb, tb, 4)
                pull = pulls[k].astype(bool)
                pull_ids = np.concatenate([np.where(pull & (uniq[k] >= 0),
                                                    uniq[k], -1), pfids[k]])
                if pull.any() or (pfids[k] >= 0).any():
                    work["k1"] += roofline.k1_bytes(
                        pull_ids.size, roofline.distinct(pull_ids, 0, R), W,
                        tb, 4, 4)
                work["k1"] += roofline.k1_bytes(
                    U, roofline.distinct(slots[k], 0, C), 2 * W, 4, 4, 4)
                work["k3"] += roofline.k3_bytes(
                    n, int((uniq[k] >= 0).sum()), W, 4)
                if cfg["reference"] == "dfm":
                    work["k5"] += roofline.k5_bytes(
                        self.B, self.F, cfg["embedding_dim"], True)
        return work

    def step_flops(self):
        """The tower's forward and backward operations a step."""
        return self.ref.flops(self.run.cfg, self.B, True)

    # -- the churned steps, after the window ------------------------------
    def _held(self, ids, slots):
        """The tower, the table's rows `ids` and the cache's rows `slots`
        as the program holds them now."""
        dev = self.state.table.device
        return {"tower": checks.tower_snapshot(self.state),
                "table": self.state.table[torch.as_tensor(
                    ids, device=dev)].cpu(),
                "cache": self.state.cache[torch.as_tensor(
                    slots, device=dev)].cpu()}

    def _stage_before(self, at, arrays):
        """At the pop of the churned steps, before they run: the first
        step's place in the programs popped (the stream's order repeats
        each epoch), the programs, and the rows of every id that the
        stream's batches or the programs name and the slots the programs
        name, as they stand."""
        _, slots, _, fids, fslots, _, _, uniq, _ = arrays
        R, C, B = self.eng.num_rows, self.eng.cache_rows, self.B
        batches = [self.ids[p * B:(p + 1) * B].reshape(-1) for p in
                   ((at + j) % self.steps_per_epoch
                    for j in range(slots.shape[0]))]
        ids = np.unique(np.concatenate([*batches, uniq[uniq >= 0],
                                        fids[(fids >= 0) & (fids < R)]]))
        held = np.unique(np.concatenate([
            slots[(slots >= 0) & (slots < C)],
            fslots[(fslots >= 0) & (fslots < C)]]))
        self.stage.update(at=at, arrays=arrays, ids=ids, slots=held,
                          before=self._held(ids, held))

    def _churned_steps(self, k):
        """k more steps through the window's call, once the window has
        closed and the cache churns: the program's state around them."""
        self.stage = {}
        losses = [float(x) for x in self._chunk(k).cpu()]
        st = self.stage
        st.update(losses=losses, after=self._held(st["ids"], st["slots"]),
                  R=self.eng.num_rows, steps_per_epoch=self.steps_per_epoch)

    def free(self):
        self._churned_steps(self.run.mix["check_steps"])
        self.planner.close()
        del self.state, self.eng, self.planner, self.device_data

    def judge(self):
        if not self.stream_order:
            print("the planner's first steps are not in stream order",
                  file=self.run.err)
        numbers = checks.reference_steps(self.run, self.prog, self.n)
        numbers.update(checks.churned_steps(self.run, self.stage, self.n))
        return numbers
