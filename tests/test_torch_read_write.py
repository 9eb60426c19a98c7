"""K1 read by position with f32 output, K2 with the learning rate applied
inside, and the engine steps built on them, against the JAX package and
against the route they replace (dedup, read the unique rows, `[inv]`,
widen; `-lr * g` then K2), run through the plain versions.

Tolerances: K1 and K2 are bit-exact (bf16 -> f32 is exact; `-lr * g` is
one f32 multiply in both). `Engine.predict` equals the replaced dedup
route bit for bit (the same f32 tower input) and JAX's eval within 1e-6
(the f32 towers sum in another order, as in tests/test_torch_engine.py).
One SGD or adam step equals the replaced route bit for bit; against JAX
the parity tests of tests/test_torch_train.py hold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herald_tpu import HeraldConfig as JaxConfig
from herald_tpu.data import synthetic_ctr_data
from herald_tpu.models import get_model
from herald_tpu.ops.pallas import embedding_gather as pallas_gather
from herald_tpu.ops.pallas import rows_scatter_add as pallas_scatter
from herald_tpu.train.engine import Engine as JaxEngine
from herald_tpu_torch import Engine, HeraldConfig
from herald_tpu_torch.bridge import state_from_numpy
from herald_tpu_torch.models.base import bce_with_logits
from herald_tpu_torch.ops import segment_sum_grads
from herald_tpu_torch.ops.kernels import (embedding_gather,
                                          embedding_gather_ref,
                                          rows_scatter_add,
                                          rows_scatter_add_ref)
from herald_tpu_torch.train.engine import TrainState

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
WIDTHS = [13, 128, 513]      # ragged, wdl's, dfm's (odd: unaligned rows)


def _to_torch(a):
    """A JAX or numpy array as a torch tensor with the same bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x.view(torch.int32)).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


def _table(name, R, D, seed):
    jdt, _ = DTYPES[name]
    rng = np.random.default_rng(seed)
    jt = jnp.asarray(rng.standard_normal((R, D)).astype(np.float32), jdt)
    return jt, _to_torch(jt)


# ----------------------------------------------------------------------
# K1 with f32 output
# ----------------------------------------------------------------------

@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_gather_f32_out_equals_pallas_then_astype(name, D, id_dtype):
    R, N = 512, 48
    jt, tt = _table(name, R, D, seed=D)
    rng = np.random.default_rng(D + 1)
    ids = rng.integers(0, R, N).astype(np.int32)
    ids[::2] |= 1                     # odd rows: unaligned at D = 513
    got = embedding_gather(tt, torch.from_numpy(ids).to(id_dtype),
                           torch.float32)
    assert got.dtype == torch.float32 and got.shape == (N, D)
    pal = pallas_gather(jt, jnp.asarray(ids), interpret=True)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(pal.astype(jnp.float32)))
    # the table-dtype read, widened, is the same
    assert torch.equal(got, embedding_gather(tt, torch.from_numpy(ids))
                       .to(torch.float32))


@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_gather_f32_out_zero_rows_like_fill_read(name, D):
    R, N = 1001, 200
    jt, tt = _table(name, R, D, seed=D + 2)
    rng = np.random.default_rng(D + 3)
    ids = rng.integers(0, R, N).astype(np.int32)
    ids[::9] = R + rng.integers(0, 1000, len(ids[::9]))
    ids[4] = R
    got = embedding_gather(tt, torch.from_numpy(ids), torch.float32)
    want = jt.at[jnp.asarray(ids)].get(mode="fill", fill_value=0)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(want.astype(jnp.float32)))
    assert not got[torch.from_numpy(ids >= R)].any()


@pytest.mark.parametrize("table_dtype,out_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float16),
    (torch.float32, torch.float64)])
def test_gather_refuses_an_out_dtype_it_does_not_write(table_dtype,
                                                       out_dtype):
    table = torch.zeros(8, 4, dtype=table_dtype)
    with pytest.raises(ValueError, match="out_dtype"):
        embedding_gather(table, torch.arange(3), out_dtype)
    with pytest.raises(ValueError, match="out_dtype"):
        embedding_gather_ref(table, torch.arange(3), out_dtype)


# ----------------------------------------------------------------------
# K2 with lr
# ----------------------------------------------------------------------

@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_scatter_with_lr_equals_scaled_grads_and_pallas(name, D):
    R, N = 104, 40
    jt, tt = _table(name, R, D, seed=D + 4)
    rng = np.random.default_rng(D + 5)
    ids = rng.permutation(np.arange(1, R, 2))[:N].astype(np.int32)  # odd
    g = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    lr = torch.tensor(0.37, dtype=torch.float32)
    got = rows_scatter_add(tt.clone(), torch.from_numpy(ids), g, lr=lr)
    scaled = -lr * g
    want = rows_scatter_add_ref(tt.clone(), torch.from_numpy(ids), scaled)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    pal = pallas_scatter(jnp.array(jt), jnp.asarray(ids),
                         jnp.asarray(scaled.numpy()), interpret=True)
    np.testing.assert_array_equal(_bits(got), _bits(pal))


@pytest.mark.parametrize("lr,grad_dtype", [
    (0.5, torch.float32),                               # a host float
    (torch.tensor([0.5]), torch.float32),               # not 0-d
    (torch.tensor(0.5, dtype=torch.float64), torch.float32),
    (torch.tensor(0.5), torch.bfloat16)])               # bf16 grads
def test_scatter_refuses_an_lr_it_does_not_take(lr, grad_dtype):
    table, ids = torch.zeros(8, 4), torch.arange(2)
    grads = torch.ones(2, 4, dtype=grad_dtype)
    with pytest.raises(ValueError, match="lr"):
        rows_scatter_add(table, ids, grads, lr=lr)
    with pytest.raises(ValueError, match="lr"):
        rows_scatter_add_ref(table, ids, grads, lr=lr)
    assert not table.any()


# ----------------------------------------------------------------------
# the engine: eval without dedup, steps against the replaced route
# ----------------------------------------------------------------------

ROWS, B = 1203, 16      # the table pads to 1208 rows


def _engines(dt, opt="sgd", steps=2):
    jdt, _ = DTYPES[dt]
    jcfg = JaxConfig(model="wdl_criteo", batch_size=B, embedding_dim=8,
                     learning_rate=0.5, optimizer=opt, table_dtype=jdt)
    spec = get_model("wdl_criteo").spec
    dense, sparse, labels = synthetic_ctr_data(spec, B * 6, seed=21,
                                               num_rows=ROWS)
    jeng = JaxEngine(jcfg, table_rows=ROWS)
    jst = jeng.init_state(0)
    for i in range(steps):
        sl = slice(i * B, (i + 1) * B)
        jst, _ = jeng.train_step(jst, dense[sl], sparse[sl], labels[sl])
    eng = Engine(HeraldConfig.from_json(jcfg.to_json()), table_rows=ROWS,
                 device="cpu")
    st = state_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    return jeng, jst, eng, st, (dense, sparse, labels)


def _dedup_scores(eng, state, d, s):
    """The replaced eval route: dedup, the unique rows through the plain
    K1, `[inv]`, widen, tower, sigmoid."""
    ids = torch.from_numpy(s.astype(np.int32))
    uniq, inv = torch.unique(ids.reshape(-1), sorted=True,
                             return_inverse=True)
    emb = embedding_gather_ref(state.table, uniq)[inv].reshape(
        *ids.shape, eng.width).to(torch.float32)
    return torch.sigmoid(eng.model.apply(state.dense, emb,
                                         torch.from_numpy(d)))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_predict_reads_by_position_like_jax_and_the_dedup_route(dt):
    jeng, jst, eng, st, (dense, sparse, _) = _engines(dt)
    d, s = dense[3 * B:4 * B], sparse[3 * B:4 * B].copy()
    s[1] = s[0]                          # duplicate ids across samples
    s[2, :5] = s[2, 5]                   # and within one
    s[3, ::4] = 1208 + np.arange(len(s[3, ::4]))   # beyond the padded rows
    s[4, 7] = 100_000
    got = eng.predict(st, d, s)
    want = np.asarray(jeng.predict(jst, d, s))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert torch.equal(got, _dedup_scores(eng, st, d, s))


def test_eval_calls_no_dedup(monkeypatch):
    _, _, eng, st, (dense, sparse, labels) = _engines("bf16", steps=0)

    def refuse(*a, **k):
        raise AssertionError("the eval step dedups")

    monkeypatch.setattr(torch, "unique", refuse)
    eng.predict(st, dense[:B], sparse[:B])
    ev = eng.evaluate(st, dense, sparse, labels)
    assert 0.0 <= ev["auc"] <= 1.0


def _replaced_step(eng, state, d, s, y):
    """The step before reads by position: the unique rows through the
    plain K1, `[inv]` into table-dtype activations (a table-dtype leaf for
    the dedup path, widened before the grad for SGD), and SGD's
    `-lr * g` as its own multiply before the plain K2."""
    step = state.step + 1
    ids = torch.as_tensor(s.astype(np.int32))
    uniq, inv = torch.unique(ids.reshape(-1), sorted=True,
                             return_inverse=True)
    emb = embedding_gather_ref(state.table, uniq)[inv].reshape(
        B, -1, eng.width)
    if eng._fast_local_sgd:
        emb = emb.to(torch.float32)
    params = {k: v.detach().requires_grad_(True)
              for k, v in state.dense.items()}
    emb = emb.detach().requires_grad_(True)
    logits = eng.model.apply(params, emb.to(torch.float32),
                             torch.as_tensor(d))
    loss = bce_with_logits(logits, torch.as_tensor(y))
    grads = torch.autograd.grad(loss, [*params.values(), emb])
    dense, dense_slots = eng.dense_opt.apply_dense(
        state.dense, dict(zip(params, grads[:-1])), state.dense_slots, step,
        lr=eng._lr_fn(step))
    if eng._fast_local_sgd:
        g_uniq = segment_sum_grads(grads[-1], inv, uniq.shape[0])
        rows_scatter_add_ref(state.table, uniq, -eng._elr_fn(step) * g_uniq)
        table, slots = state.table, state.table_slots
    else:
        table, slots = eng._apply_sparse_grads(
            state.table, state.table_slots, step, uniq, inv, grads[-1])
    return TrainState(table, slots, dense, dense_slots, step), loss.detach()


def _clone(state):
    return TrainState(state.table.clone(),
                      {k: v.clone() for k, v in state.table_slots.items()},
                      {k: v.clone() for k, v in state.dense.items()},
                      {k: {n: x.clone() for n, x in v.items()}
                       for k, v in state.dense_slots.items()},
                      state.step.clone())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_one_step_equals_the_replaced_route(opt, dt):
    _, _, eng, st, (d, s, y) = _engines(dt, opt)
    sl = slice(2 * B, 3 * B)
    ref, want_loss = _replaced_step(eng, _clone(st), d[sl], s[sl], y[sl])
    got, stats = eng.train_step(st, d[sl], s[sl], y[sl])
    assert float(stats["loss"]) == float(want_loss)
    np.testing.assert_array_equal(_bits(got.table), _bits(ref.table))
    for k in ref.table_slots:
        np.testing.assert_array_equal(_bits(got.table_slots[k]),
                                      _bits(ref.table_slots[k]))
    for k in ref.dense:
        assert torch.equal(got.dense[k], ref.dense[k])
        for n in ref.dense_slots[k]:
            assert torch.equal(got.dense_slots[k][n], ref.dense_slots[k][n])
