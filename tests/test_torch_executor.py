"""The port's executor pieces on the CPU: what lets a step run as a CUDA
graph on the card (`herald_tpu_torch/train/graphs.py`).

- `unique_static` against JAX's `jnp.unique(size=U, return_inverse=True,
  fill_value=-1)` (`herald_tpu/train/engine.py:301-302`), bit for bit.
- `write_rows` against JAX's `.at[].set(mode="drop")`, bit for bit.
- A `TorchDispatchMode` guard that fails on every op that makes the host
  wait for a card (`.item()`, `nonzero`, `unique`, `masked_select`, an
  index by a bool tensor, a tensor made from host data), around every
  step body the graphs capture: plain SGD, the dedup path, FAE, the
  cached step (flush, pull, prefetch insert, pinned tier) and the eval
  steps. The kernels' plain versions are exempt: they run only on the
  CPU.
- The cached step's fixed-length write lists against the ragged writes
  they replaced, over a stream that flushes, prefetches and pins.
- `multistep`, whose milestones go to the step's device once.
- Packing, unpacking and the write-back of a state.

The graphs themselves run only on the card; `chip_smoke.py` holds
captured steps against uncaptured ones there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from herald_tpu_torch import HeraldConfig
from herald_tpu_torch.data import synthetic_ctr_data
from herald_tpu_torch.models import get_model
from herald_tpu_torch.ops.embedding import unique_static
from herald_tpu_torch.ops.kernels import fm, gather, hot_gather, scatter
from herald_tpu_torch.ops.kernels import segment
from herald_tpu_torch.optim.schedules import get_schedule
from herald_tpu_torch.train.cached import CachedEngine
from herald_tpu_torch.train.engine import Engine, write_rows
from herald_tpu_torch.train.fae import FaeEngine, build_hot_lut
from herald_tpu_torch.train.graphs import (feed_inputs, leaves, pack,
                                           pack_tensors, unpack, write_back)

aten = torch.ops.aten
ROWS, B = 2000, 16


# ----------------------------------------------------------------------
# the static-size dedup
# ----------------------------------------------------------------------
def _ids(case, dtype):
    rng = np.random.default_rng(3)
    n = 12 * 26
    if case == "all_equal":
        ids = np.full(n, 17)
    elif case == "all_distinct":
        ids = rng.permutation(10 * n)[:n]
    elif case == "cold_with_minus_one":     # the FAE step's cold ids
        ids = rng.integers(0, 50, n)
        ids[rng.random(n) < 0.7] = -1
    else:
        ids = rng.integers(0, 40, n)
    return ids.astype(dtype).reshape(12, 26)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("case", ["all_equal", "all_distinct",
                                  "cold_with_minus_one", "duplicates"])
def test_unique_static_matches_jax(case, dtype):
    ids = _ids(case, dtype)
    U = ids.size
    ju, jinv = jnp.unique(jnp.asarray(ids).reshape(-1), size=U,
                          return_inverse=True, fill_value=-1)
    tu, tinv = unique_static(torch.from_numpy(ids), U)
    assert tu.dtype == torch.from_numpy(ids).dtype and tu.shape == (U,)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tinv.numpy(),
                                  np.asarray(jinv).reshape(-1))


def test_unique_static_refuses_a_size_below_the_ids():
    with pytest.raises(ValueError, match="size"):
        unique_static(torch.arange(8), 7)


# ----------------------------------------------------------------------
# the drop-write
# ----------------------------------------------------------------------
def _drop_case(case, rows):
    # positive sentinels only: JAX's drop mode wraps negative indices
    rng = np.random.default_rng(4)
    idx = rng.permutation(rows)[:10]
    if case == "some_dropped":
        idx[[1, 4, 7]] = [rows + 2, rows, rows + 5]
    elif case == "all_dropped":
        idx[:] = rows + np.array([0, 1, 2, 9, 0, 1, 3, 4, 4, 7])
    elif case == "at_padded_rows":       # the engine's dedup-path sentinel
        idx[[0, 5]] = rows
    elif case == "at_table_plus_one":
        idx[[2, 3, 9]] = rows + 1
    return idx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["none_dropped", "some_dropped",
                                  "all_dropped", "at_padded_rows",
                                  "at_table_plus_one"])
def test_write_rows_matches_jax_drop_write(case, dtype):
    rows, width = 24, 5
    rng = np.random.default_rng(5)
    dst = rng.standard_normal((rows, width)).astype(np.float32)
    dst[0, 1] = -0.0                     # row 0 keeps its bits, sign too
    vals = rng.standard_normal((10, width)).astype(np.float32)
    idx = _drop_case(case, rows)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jnp.asarray(dst, jdt).at[jnp.asarray(idx)].set(
        jnp.asarray(vals).astype(jdt), mode="drop")
    got = torch.from_numpy(dst).to(getattr(torch, dtype))
    write_rows(got, torch.from_numpy(idx), torch.from_numpy(vals))
    bits = np.int16 if dtype == "bfloat16" else np.int32
    np.testing.assert_array_equal(
        got.view(torch.int16 if dtype == "bfloat16" else torch.int32).numpy(),
        np.asarray(want).view(bits))


def test_write_rows_drops_where_keep_is_false():
    dst = torch.zeros(6, 2)
    write_rows(dst, torch.tensor([1, 2, 3]), torch.ones(3, 2),
               keep=torch.tensor([True, False, True]))
    assert dst[:, 0].tolist() == [0, 1, 0, 1, 0, 0]


# ----------------------------------------------------------------------
# the guard
# ----------------------------------------------------------------------
_WAITS = {aten._local_scalar_dense, aten.nonzero, aten._unique2,
          aten.unique_dim, aten.unique_consecutive, aten.masked_select,
          aten.lift_fresh, aten.lift_fresh_copy}
_BY_INDEX = {aten.index, aten.index_put, aten.index_put_,
             aten._index_put_impl_}


class HostWaitGuard(TorchDispatchMode):
    """Records every op that would make the host wait for a card: a read
    of a device value (`.item()`, `bool()`), an op whose output size
    depends on the data (`nonzero`, `unique`, `masked_select`, an index by
    a bool tensor), and a tensor made from host data (a host-to-device
    copy on the card), or a copy from the host to another device. Ops run
    inside a kernel's plain version are exempt (`exempt`)."""

    def __init__(self):
        super().__init__()
        self.found, self.exempt = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.exempt:
            why = self._why(func, args, kwargs)
            if why:
                self.found.append(why)
        return func(*args, **kwargs)

    @staticmethod
    def _why(func, args, kwargs):
        packet = func.overloadpacket
        if packet in _WAITS:
            return str(func)
        if packet in _BY_INDEX and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1]):
            return f"{func} by a bool tensor"
        if packet in (aten._to_copy, aten.copy_):
            src = args[1] if packet is aten.copy_ else args[0]
            dst = args[0].device if packet is aten.copy_ else \
                kwargs.get("device") or args[0].device
            if src.device.type == "cpu" and torch.device(dst).type != "cpu":
                return f"{func} from the host"
        return None


@pytest.fixture
def guard(monkeypatch):
    """The guard, with every kernel's plain version exempt."""
    g = HostWaitGuard()
    for mod in (gather, scatter, segment, hot_gather, fm):
        for name, fn in list(vars(mod).items()):
            if name.endswith("_ref") and callable(fn):
                def exempt(*a, _fn=fn, **kw):
                    g.exempt += 1
                    try:
                        return _fn(*a, **kw)
                    finally:
                        g.exempt -= 1
                monkeypatch.setattr(mod, name, exempt)
    return g


_X = torch.tensor([3, 1, 2, 1])


@pytest.mark.parametrize("op", [
    lambda: torch.unique(_X),
    lambda: _X.sum().item(),
    lambda: bool(_X.any()),
    lambda: _X[_X > 1],
    lambda: _X.nonzero(),
    lambda: torch.masked_select(_X, _X > 1),
    lambda: torch.tensor([1, 2]),
], ids=["unique", "item", "bool", "bool_index", "nonzero",
        "masked_select", "from_host_data"])
def test_guard_catches_each_kind_of_host_wait(guard, op):
    with guard:
        op()
    assert guard.found


def test_guard_exempts_the_kernels_plain_versions(guard):
    ids, table, grads = torch.tensor([0, -1, 9]), torch.ones(5, 4), \
        torch.ones(3, 4)
    with guard:
        segment.hot_onehot_push(ids, grads, 3)
        gather.embedding_gather(table, ids)
    assert guard.found == []


def _cfg(**kw):
    return HeraldConfig(**{**dict(model="wdl_criteo", batch_size=B,
                                  embedding_dim=8, learning_rate=0.1), **kw})


def _batch(n=4 * B, seed=7, rows=ROWS, model="wdl_criteo"):
    d, s, y = synthetic_ctr_data(get_model(model).spec, n, seed=seed,
                                 num_rows=rows)
    return d.astype(np.float32), s.astype(np.int32), y.astype(np.float32)


@pytest.mark.parametrize("model", ["wdl_criteo", "dfm_criteo"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_plain_and_eval_steps_never_wait(guard, opt, model):
    eng = Engine(_cfg(optimizer=opt, model=model), table_rows=ROWS,
                 device="cpu")
    state = eng.init_state(0)
    d, s, y = _batch(model=model)
    state, _ = eng.train_step(state, d[:B], s[:B], y[:B])      # warm-up
    a = feed_inputs(eng._batch_feed({"d": (d[B:2 * B], np.float32),
                                     "s": (s[B:2 * B], np.int32),
                                     "y": (y[B:2 * B], np.float32)}),
                    eng.device)
    with guard:
        state, loss = eng._train_step_body(state, a)
        eng._eval_step_body(state, a)
    assert guard.found == [], guard.found
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_fae_steps_never_wait(guard, opt):
    eng = FaeEngine(_cfg(model="fae_wdl_criteo", optimizer=opt),
                    table_rows=ROWS, hot_rate=0.05, device="cpu")
    state = eng.init_fae_state(0)
    d, s, y = _batch()
    lut, _ = build_hot_lut(s, ROWS, hot_rate=0.05)
    state, _ = eng.train_step_fae(state, lut, d[:B], s[:B], y[:B])
    cold, hot = eng.split_batch(lut, s[B:2 * B])
    assert (cold < 0).any() and (cold >= 0).any()
    a = feed_inputs(eng._host_feed({"d": d[B:2 * B], "cold": cold,
                                    "hot": hot, "y": y[B:2 * B]}),
                    eng.device)
    with guard:
        state, _ = eng._fae_step_body(state, a)
        eng._fae_eval_body(state, a)
    assert guard.found == [], guard.found


def _cached_cfg(**kw):
    # a cache of two batches' ids (flushes on most steps), a pinned tier
    # over the concentrated ids, and prefetches hoisted into early steps
    return _cfg(cache_limit=2 * B * 26, pinned_rows=32,
                staleness_bound=2, sched_pull_target=8,
                sched_hoist_window=6, sched_prefetch_slots=64, **kw)


def _hot_batch(n, seed=9):
    d, s, y = _batch(n, seed=seed)
    s = np.where(np.random.default_rng(seed).random(s.shape) < 0.5, s % 48,
                 s).astype(np.int32)
    return d, s, y


def test_cached_steps_never_wait(guard):
    eng = CachedEngine(_cached_cfg(), table_rows=ROWS, device="cpu")
    d, s, y = _hot_batch(24 * B, seed=11)
    planner = eng.make_planner(s, epochs=1, n_threads=1)
    state = eng.init_cached_state(0)
    state, _ = eng.train_epoch_cached(state, planner, d, s, y, steps=1)
    staged = eng._stage_chunk(*planner.pop_chunk(23), d, s, y,
                              index_feed=False)
    seen = set()
    with guard:
        for k in range(staged.K):
            a = unpack(staged.packed[k], staged.layout)
            state, _ = eng._cached_step_body(state, a, staged.steps[k])
            seen.add(staged.steps[k])
    planner.close()
    assert guard.found == [], guard.found
    # flushes to table and cache, pulls, prefetch inserts, updates
    assert all(any(v[i] for v in seen) for i in range(5)), seen


# ----------------------------------------------------------------------
# fixed-length write lists against the ragged writes they replaced
# ----------------------------------------------------------------------
class RaggedWrites(CachedEngine):
    """The cached engine writing only each step's kept entries, selected
    by a bool mask (the form before the lists had a fixed length)."""

    writes = {}

    @staticmethod
    def _write_arrays(host, masks):
        kept = CachedEngine._write_arrays(host, masks)
        for name, (mask, target) in masks.items():
            host[f"{name}_keep"] = mask.astype(np.int32)
            host[f"{name}_raw"] = np.where(mask, target, 0).astype(np.int64)
        return kept

    @staticmethod
    def _write(dst, a, name, src):
        keep = a[f"{name}_keep"].bool()
        dst.index_copy_(0, a[f"{name}_raw"][keep],
                        src[keep].to(dst.dtype))
        RaggedWrites.writes[name] = RaggedWrites.writes.get(name, 0) + 1


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_fixed_write_lists_equal_ragged_writes(opt):
    d, s, y = _hot_batch(24 * B, seed=11)
    out = []
    RaggedWrites.writes = {}
    for cls in (CachedEngine, RaggedWrites):
        eng = cls(_cached_cfg(embed_optimizer=opt), table_rows=ROWS,
                  device="cpu")
        planner = eng.make_planner(s, epochs=1, n_threads=1)
        state = eng.init_cached_state(0)
        losses = []
        for _ in range(4):
            state, st = eng.train_epoch_cached(state, planner, d, s, y,
                                               steps=6)
            losses.append(st["loss"])
        state = eng.sync_cache(state, planner)
        planner.close()
        out.append((state, torch.cat(losses)))
    assert set(RaggedWrites.writes) == {"ft", "fc", "pf", "up"}, \
        RaggedWrites.writes
    (a, la), (b, lb) = out
    assert torch.equal(la, lb)
    la_, lb_ = leaves(a), leaves(b)
    for path in la_:
        assert torch.equal(la_[path].reshape(-1).view(torch.uint8),
                           lb_[path].reshape(-1).view(torch.uint8)), path


# ----------------------------------------------------------------------
# multistep
# ----------------------------------------------------------------------
def test_multistep_values_and_one_copy_of_its_milestones():
    ms, lr, gamma = [30, 10, 20], 0.5, 0.1
    f = get_schedule("multistep", lr, milestones=ms)
    for i in range(1, 40):
        step = torch.tensor(i, dtype=torch.int32)
        k = torch.tensor(sum(i > m for m in ms))
        want = (lr * gamma ** k.to(torch.float32)).to(torch.float32)
        got = f(step)
        assert got.dtype == torch.float32
        assert torch.equal(got, want), i
    guard, step = HostWaitGuard(), torch.tensor(5, dtype=torch.int32)
    with guard:
        f(step)
    assert guard.found == []


# ----------------------------------------------------------------------
# packing and the write-back
# ----------------------------------------------------------------------
def test_pack_and_unpack_one_step_and_many():
    rng = np.random.default_rng(2)
    arrays = {"d": rng.standard_normal((3, 4, 13)).astype(np.float32),
              "s": rng.integers(0, 9, (3, 4, 26)).astype(np.int32),
              "y": rng.random((3, 4)).astype(np.float32),
              "t": rng.integers(-1, 9, (3, 5)).astype(np.int64),
              "e": np.zeros((3, 0), np.int32)}
    buf, layout = pack(arrays, steps=3)
    assert buf.shape == (3, layout.nbytes) and layout.nbytes % 16 == 0
    assert all(f.offset % 16 == 0 for f in layout.fields)
    dev, same = pack_tensors({k: torch.from_numpy(v)
                              for k, v in arrays.items()}, 3)
    assert same == layout
    for k in range(3):
        one, one_layout = pack({n: a[k] for n, a in arrays.items()})
        assert one_layout == layout
        for b in (buf[k], dev[k], one):     # the padding bytes are unset
            got = unpack(b, layout)
            for n, a in arrays.items():
                np.testing.assert_array_equal(got[n].numpy(), a[k])


def test_write_back_copies_bits_and_keeps_the_state():
    old = {"w": torch.zeros(3), "b": torch.zeros(2, dtype=torch.bfloat16),
           "step": torch.zeros((), dtype=torch.int32)}
    new = {"w": torch.tensor([-0.0, float("nan"), 2.0]),
           "b": torch.ones(2, dtype=torch.bfloat16), "step": old["step"]}
    ids = {k: id(v) for k, v in old.items()}
    write_back(leaves(old), leaves(new))
    assert {k: id(v) for k, v in old.items()} == ids
    assert torch.equal(old["w"].view(torch.int32), new["w"].view(torch.int32))
    assert torch.equal(old["b"], new["b"])
    with pytest.raises(ValueError, match="structure"):
        write_back(leaves(old), leaves({"w": new["w"]}))
    with pytest.raises(ValueError, match="became"):
        write_back(leaves({"w": old["w"]}), leaves({"w": torch.zeros(4)}))
