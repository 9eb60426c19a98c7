"""The port's training step against herald_tpu's Engine, from one bridged
JAX state and one batch stream (wdl_criteo, and dfm_criteo for the FM
term; 1,000 rows, embedding 8, batch 16, lr 0.01, 6 steps).

Tolerances:
- f32 table: per-step loss within 1e-6; final table, dense params and
  slots within 1e-5. The f32 towers sum in another order (XLA against
  torch's CPU kernels), and adagrad and adam divide each update by the
  running gradient magnitude, which turns f32 rounding of a near-zero
  dense gradient into a larger step (measured: adam dense 6.2e-6).
- bf16 table: JAX sums an id's duplicate gradients in bf16, one rounding
  per duplicate (the SGD path adds every duplicate into the table), where
  the port sums them in f32 through K3 and rounds once; and a cotangent
  that the two f32 towers compute one f32 ulp apart can round to
  neighbouring bf16 values. So a value can land a bf16 ulp or two away:
  - SGD: per-step loss within 1e-5 (measured max 3.0e-7), table within
    2^-7 of the value plus 2^-13 (measured max 6.1e-5). On batches
    without duplicate ids the SGD table is bit-exact.
  - adagrad and adam divide each element's update by its running
    gradient, so an element whose gradient is tiny turns a one-ulp
    difference into up to a whole step of lr. All but 1% of the table's
    values stay within two bf16 ulps (measured: 25 of 8,000 do not);
    table and dense params within 2 lr = 0.02 (measured max 0.011 and
    0.0088); per-step loss within 1e-3 (measured max 1.7e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herald_tpu import HeraldConfig as JaxConfig
from herald_tpu.data import synthetic_ctr_data
from herald_tpu.models import get_model
from herald_tpu.train.engine import Engine as JaxEngine
from herald_tpu_torch import Engine, HeraldConfig
from herald_tpu_torch.bridge import state_from_numpy
from herald_tpu_torch.ops.kernels import KERNELS
from herald_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

ROWS, B, STEPS, LR = 1000, 16, 6, 0.01
_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _setup(opt, dt, model="wdl_criteo", lr=LR):
    jcfg = JaxConfig(model=model, batch_size=B, embedding_dim=8,
                     learning_rate=lr, optimizer=opt, table_dtype=_DT[dt])
    spec = get_model(model).spec
    data = synthetic_ctr_data(spec, B * STEPS + 40, seed=3, num_rows=ROWS)
    jeng = JaxEngine(jcfg, table_rows=ROWS)
    jst = jeng.init_state(0)
    eng = Engine(HeraldConfig.from_json(jcfg.to_json()), table_rows=ROWS,
                 device="cpu")
    st = state_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    return jeng, jst, eng, st, data


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam"])
def test_train_steps_match_jax(opt, dt):
    _run_and_check("wdl_criteo", opt, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_dfm_train_steps_match_jax(opt, dt):
    """DeepFM (dfm_criteo, table width 9): the FM term through K5 both
    ways, at the tolerances above with two exceptions, each for its
    reason:
    - adam runs at lr 1e-3. At 1e-2 Adam moves every DNN weight (init
      scale 0.01) by its own size each step, a regime in which a 1e-7
      rounding difference grows to whole steps within 6 steps (measured
      in f32: 58% of W1 beyond 1e-5, 3 elements beyond 2 lr); at 1e-3 the
      f32 run stays within 1.3e-7.
    - SGD with a bf16 table: the 1st-order column enters each logit with
      weight 1, where WDL's head weighs an embedding element by about
      0.01, so a bf16 ulp of difference in that column moves the loss more:
      loss within 1e-4 (measured 3.6e-5), and 0.1% of the table's values
      may land beyond two bf16 ulps (measured 1 of 9,000), all within
      2 lr."""
    if opt == "sgd":
        _run_and_check("dfm_criteo", opt, dt, bf16_sgd_loss=1e-4,
                       bf16_sgd_share=1e-3)
    else:
        _run_and_check("dfm_criteo", opt, dt, lr=1e-3)


def _run_and_check(model, opt, dt, lr=LR, bf16_sgd_loss=1e-5,
                   bf16_sgd_share=0.0):
    jeng, jst, eng, st, (d, s, y) = _setup(opt, dt, model, lr)
    assert eng._fast_local_sgd == jeng._fast_local_sgd == (opt == "sgd")
    for i in range(STEPS):
        sl = slice(i * B, (i + 1) * B)
        jst, jstats = jeng.train_step(jst, d[sl], s[sl], y[sl])
        st, stats = eng.train_step(st, d[sl], s[sl], y[sl])
        tol = 1e-6 if dt == "f32" else bf16_sgd_loss if opt == "sgd" \
            else 1e-3
        assert abs(float(stats["loss"]) - float(jstats["loss"])) <= tol, i
        assert int(stats["overflow"]) == 0
    assert int(st.step) == int(jst.step) == STEPS
    assert st.table.dtype == {"f32": torch.float32,
                              "bf16": torch.bfloat16}[dt]
    got, want = _f32(st.table), _f32(jst.table)
    normalised = dt == "bf16" and opt != "sgd"
    if dt == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    elif opt == "sgd" and not bf16_sgd_share:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -13)
    else:
        beyond = np.abs(got - want) > 2 ** -7 * np.abs(want) + 2 ** -13
        share = bf16_sgd_share if opt == "sgd" else 0.01
        assert beyond.mean() <= share, beyond.sum()
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * lr)
    for k in jst.dense:
        _check_dense(st.dense[k].numpy(), np.asarray(jst.dense[k]), opt, dt,
                     lr)
        assert set(st.dense_slots[k]) == set(jst.dense_slots[k])
        for s_ in jst.dense_slots[k]:
            _check_dense(st.dense_slots[k][s_].numpy(),
                         np.asarray(jst.dense_slots[k][s_]), opt, dt, lr)
    assert set(st.table_slots) == set(jst.table_slots)
    for k in jst.table_slots:
        assert st.table_slots[k].dtype == st.table.dtype
        np.testing.assert_allclose(_f32(st.table_slots[k]),
                                   _f32(jst.table_slots[k]), rtol=0,
                                   atol=2 * lr if normalised else 1e-5)


def _check_dense(got, want, opt, dt, lr):
    """A dense param or slot. Under a normalised optimizer (adagrad, adam)
    the f32 tower's rounding of a near-zero gradient moves that element's
    step, as with the bf16 table: on hosts whose XLA fuses with FMA, 1 to 3
    of 65,536 f32 elements land 1.2e-5 to 2.2e-5 away. So there every
    element stays within 2 lr, and under f32 at most 0.1% beyond 1e-5. SGD
    keeps 1e-5 (f32 table) or 1e-6 (bf16 table)."""
    if opt == "sgd":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 if dt == "f32" else 1e-6)
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * lr)
    if dt == "f32":
        beyond = np.abs(got - want) > 1e-5
        assert beyond.mean() <= 1e-3, beyond.sum()


def test_bf16_sgd_without_duplicate_ids_is_bit_exact():
    jeng, jst, eng, st, (d, _, y) = _setup("sgd", "bf16")
    rng = np.random.default_rng(4)
    s = np.concatenate([rng.permutation(ROWS)[:B * 26].reshape(B, 26)
                        for _ in range(STEPS)])
    for i in range(STEPS):
        sl = slice(i * B, (i + 1) * B)
        jst, jstats = jeng.train_step(jst, d[sl], s[sl], y[sl])
        st, stats = eng.train_step(st, d[sl], s[sl], y[sl])
        assert abs(float(stats["loss"]) - float(jstats["loss"])) <= 1e-6
    np.testing.assert_array_equal(_f32(st.table), _f32(jst.table))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_train_epoch_equals_repeated_train_step(opt):
    _, _, eng, st, (d, s, y) = _setup(opt, "f32")
    a = eng.init_state(1)
    b = eng.init_state(1)
    losses = []
    for i in range(STEPS):
        sl = slice(i * B, (i + 1) * B)
        a, stats = eng.train_step(a, d[sl], s[sl], y[sl])
        losses.append(float(stats["loss"]))
    b, stats = eng.train_epoch(b, d, s, y, steps=STEPS)
    assert stats["loss"].shape == (STEPS,) and stats["overflow"].shape == (
        STEPS,)
    assert stats["loss"].tolist() == losses
    assert torch.equal(a.table, b.table) and int(b.step) == STEPS
    assert all(torch.equal(a.dense[k], b.dense[k]) for k in a.dense)
    assert all(torch.equal(a.table_slots[k], b.table_slots[k])
               for k in a.table_slots)
    # tensors already staged as [K, B, ...] are used as they are
    c = eng.init_state(1)
    staged = [torch.as_tensor(x[:STEPS * B].reshape(STEPS, B, -1))
              for x in (d, s.astype(np.int32), y)]
    c, stats_c = eng.train_epoch(c, *staged, steps=STEPS)
    assert stats_c["loss"].tolist() == losses
    assert torch.equal(a.table, c.table)
    with pytest.raises(ValueError, match="one step"):
        eng.train_epoch(c, d[:B - 1], s[:B - 1], y[:B - 1])


def test_evaluate_after_training_matches_jax_auc():
    jeng, jst, eng, st, (d, s, y) = _setup("sgd", "f32")
    jst, _ = jeng.train_epoch(jst, d, s, y, steps=STEPS)
    st, _ = eng.train_epoch(st, d, s, y, steps=STEPS)
    val = slice(STEPS * B, None)                  # the 40 held-out rows
    want = jeng.evaluate(jst, d[val], s[val], y[val])
    got = eng.evaluate(st, d[val], s[val], y[val])
    assert abs(got["auc"] - want["auc"]) <= 1e-6
    assert abs(got["acc"] - want["acc"]) <= 1e-6


def test_train_launches_no_kernel_on_the_cpu():
    _, _, eng, st, (d, s, y) = _setup("sgd", "f32")
    before = {k: f.launches for k, f in KERNELS.items()}
    eng.train_epoch(st, d, s, y, steps=2)
    assert {k: f.launches for k, f in KERNELS.items()} == before


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_slot_trees_match_jax_and_survive_a_checkpoint(opt, tmp_path):
    """The bridge keeps JAX's `{"W1": {}, ...}` for a slotless dense
    optimizer, as init_state builds it, and a save/load round trip keeps
    every slot and the step."""
    jeng, jst, eng, st, (d, s, y) = _setup(opt, "bf16")
    mine = eng.init_state(0)
    assert set(st.dense_slots) == set(mine.dense_slots) == set(st.dense)
    for k in st.dense:
        assert set(st.dense_slots[k]) == set(mine.dense_slots[k]) == set(
            eng.dense_opt.slot_names)
    assert set(st.table_slots) == set(eng.embed_opt.slot_names)
    st, _ = eng.train_epoch(st, d, s, y, steps=2)
    save_checkpoint(st, str(tmp_path / "ck"))
    back = load_checkpoint(str(tmp_path / "ck"), "cpu",
                           padded_rows=eng.padded_rows)
    assert int(back.step) == 2 and back.step.dtype == torch.int32
    assert torch.equal(back.table, st.table)
    assert back.table_slots.keys() == st.table_slots.keys()
    assert all(torch.equal(back.table_slots[k], st.table_slots[k])
               for k in st.table_slots)
    assert back.dense_slots.keys() == st.dense_slots.keys()
    for k in st.dense:
        assert torch.equal(back.dense[k], st.dense[k])
        assert back.dense_slots[k].keys() == st.dense_slots[k].keys()
        for s_ in st.dense_slots[k]:
            assert torch.equal(back.dense_slots[k][s_], st.dense_slots[k][s_])
    # and trains on identically
    a, sa = eng.train_epoch(st, d[2 * B:], s[2 * B:], y[2 * B:], steps=2)
    b, sb = eng.train_epoch(back, d[2 * B:], s[2 * B:], y[2 * B:], steps=2)
    assert torch.equal(sa["loss"], sb["loss"]) and torch.equal(a.table,
                                                                b.table)
