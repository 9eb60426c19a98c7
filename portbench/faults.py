"""Faults the check must catch, planted in the program for a run: steps
that return their state unchanged, steps that leave out half of each
batch and take the mean over the rest, a planner that drops a pull
(the step reads an id from a slot that does not hold it) or flushes two
ids each from the other's slot, a served score altered where it is
produced. `plant(name)` is a context manager; the tests and
`control.py --program-faults` use it."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def _patched(obj, name, fn):
    old = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _unchanged():
    from herald_tpu_torch.train import cached, engine

    def still(self, state, a, *rest, **kw):
        return state, torch.full((), 0.6931, dtype=torch.float32,
                                 device=state.step.device)
    return contextlib.ExitStack(), [
        (engine.Engine, "_train_step_body", still),
        (cached.CachedEngine, "_cached_step_body", still)]


def _half_batch():
    from herald_tpu_torch.train import engine
    orig = engine.Engine._loss_and_grads

    def half(self, dense, emb, dense_x, labels, scale=None):
        h = emb.shape[0] // 2
        loss, dg, ge = orig(self, dense, emb[:h], dense_x[:h], labels[:h],
                            scale)
        return loss, dg, torch.cat([ge, torch.zeros_like(ge)])
    return contextlib.ExitStack(), [(engine.Engine, "_loss_and_grads", half)]


def _altered_score():
    from herald_tpu_torch.train import engine
    orig = engine.Engine.predict

    def altered(self, state, dense_x, sparse_ids):
        p = orig(self, state, dense_x, sparse_ids).clone()
        p[0] += 1e-3
        return p
    return contextlib.ExitStack(), [(engine.Engine, "predict", altered)]


def _planner(alter):
    """The planner's `pop_chunk` with `alter(planner, K, arrays)` applied
    to each chunk of programs it pops, before the engine stages them."""
    from herald_tpu_torch.sched import planner
    orig = planner.CachePlanner.pop_chunk

    def popped(self, steps):
        out = orig(self, steps)
        alter(self, out[0], out[1:])
        return out
    return contextlib.ExitStack(), [(planner.CachePlanner, "pop_chunk",
                                     popped)]


def _dropped_pull():
    def alter(_, K, arrays):
        pulls = arrays[2]
        for k in range(K):
            on = np.flatnonzero(pulls[k])
            if on.size:
                pulls[k][on[0]] = 0
    return _planner(alter)


def _swapped_flush():
    def alter(planner, K, arrays):
        fids, fslots = arrays[3], arrays[4]
        for k in range(K):
            on = np.flatnonzero((fids[k] >= 0) & (fslots[k] >= 0)
                                & (fslots[k] < planner.cache_rows))
            if on.size >= 2:
                i, j = on[0], on[1]
                fslots[k][i], fslots[k][j] = fslots[k][j], fslots[k][i]
    return _planner(alter)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "dropped_pull": _dropped_pull, "swapped_flush": _swapped_flush,
          "altered_score": _altered_score}


@contextlib.contextmanager
def plant(name: str):
    stack, patches = FAULTS[name]()
    with stack:
        for obj, attr, fn in patches:
            stack.enter_context(_patched(obj, attr, fn))
        yield
