"""The port's FAE engine (`herald_tpu_torch/train/fae.py`) and the
launcher's FAE branch against herald_tpu's, on the CPU (plain versions of
K1, K3 and K4), at small shapes: 1,000 or 2,000 rows, embedding 8,
batch 16 or 32, 5% of the rows hot.

The two packages draw their initial weights from different generators, so
every parity test starts both from one JAX `FaeTrainState`, converted
through numpy (`herald_tpu_torch/bridge.py`).

Tolerances of the step parity (6 steps, lr 0.01, about a third of the
positions hot), with the largest differences measured here:
- f32 tables: loss within 1e-6 (measured 1.5e-7); cold table, hot block
  and table slots within 1e-5 (1.8e-7); f32 hot slots within 1e-5 of
  their largest value (3.1e-7); dense params within 1e-5, and under
  adagrad and adam within 1e-4 with at most 0.1% beyond 1e-5 (2.2e-6):
  the f32 towers sum in another order (XLA against torch's CPU kernels),
  and adagrad and adam divide each step by the running gradient, which on
  hosts whose XLA fuses with FMA moves a few dense elements further
  (`tests/test_torch_train.py`).
- bf16 tables: both packages sum the f32 emb gradient in f32 (JAX's FAE
  emb is the f32 result of a `where`) and round once, so the sums differ
  by f32 summation order only; a sum or cotangent one f32 ulp apart can
  still round to neighbouring bf16 values. SGD: loss within 1e-5
  (1.2e-7), cold table and hot block within one bf16 ulp of the value
  plus 2^-13 (measured bit-exact). adagrad and adam turn a one-ulp
  difference of an element with a tiny gradient into up to a whole step
  of lr: all but 1% of the values within two bf16 ulps (0.44%), all
  within 2 lr (0.0134); dense params within 2 lr (0.0102); loss within
  1e-3 (1.8e-6); f32 hot slots within 1e-2 of their largest value
  (1.1e-3).
- DeepFM on Avazu (K5's plain versions) under adam runs at lr 1e-3, as
  `tests/test_torch_train.py` does for dfm_criteo: at larger rates Adam
  moves every weight by its own size each step, and a 1e-7 rounding
  difference grows to whole steps.

The hot read is held to the Pallas kernel in interpret mode plus JAX's
`where`, and to JAX's XLA fill read; the hot-gradient sum to the Pallas
push kernel in interpret mode and `jax.ops.segment_sum`. The port's read
adds the hot row to a zero row, so a hot row holding -0.0 reads +0.0;
every other bit is JAX's, and the test pins both.

The launcher is held to `herald_tpu.launch --fae` from one JAX state (the
test patches the port's `init_fae_state` to return it) with
`tests/test_torch_launch.py`'s tolerances: losses 1e-5, AUC 1e-4.
`tests/test_fae.py::test_fae_trains[hybrid]` (the row-sharded exchange)
runs over 2 and 4 gloo ranks in `tests/test_torch_fae_hybrid.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herald_tpu import HeraldConfig as JaxConfig
from herald_tpu.data import synthetic_ctr_data
from herald_tpu.launch.cli import build_parser as jax_parser
from herald_tpu.launch.cli import run_training as jax_run
from herald_tpu.models import get_model
from herald_tpu.ops.pallas import hot_onehot_gather as pallas_hot_gather
from herald_tpu.ops.pallas import hot_onehot_push as pallas_hot_push
from herald_tpu.train.fae import FaeEngine as JaxFaeEngine
from herald_tpu.train.fae import build_hot_lut as jax_build_hot_lut
from herald_tpu_torch import HeraldConfig
from herald_tpu_torch.bridge import state_from_numpy, state_to_numpy
from herald_tpu_torch.launch import cli
from herald_tpu_torch.ops.kernels import hot_onehot_push
from herald_tpu_torch.train.fae import (FaeEngine, FaeTrainState,
                                        build_hot_lut)

ROWS, B, STEPS, LR = 1000, 16, 6, 0.01
_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(model="fae_wdl_criteo", opt="sgd", dt="f32", lr=LR, rows=ROWS,
          b=B, hot_rate=0.05, seed=0):
    """(JAX engine, JAX state, port engine, port state from it)."""
    jcfg = JaxConfig(model=model, batch_size=b, embedding_dim=8,
                     learning_rate=lr, optimizer=opt, table_dtype=_DT[dt])
    jeng = JaxFaeEngine(jcfg, table_rows=rows, hot_rate=hot_rate)
    jst = jeng.init_fae_state(seed)
    eng = FaeEngine(HeraldConfig.from_json(jcfg.to_json()), table_rows=rows,
                    hot_rate=hot_rate, device="cpu")
    st = state_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    return jeng, jst, eng, st


# ----------------------------------------------------------------------
# tests/test_fae.py, on the port
# ----------------------------------------------------------------------

def test_hot_lut_picks_most_frequent():
    ids = np.array([[1, 1], [1, 2], [1, 2], [3, 4]])
    lut, hot = build_hot_lut(ids, num_rows=10, num_hot=2)
    assert set(hot.tolist()) == {1, 2}
    assert lut[1] >= 0 and lut[2] >= 0
    assert lut[3] == -1 and lut[0] == -1


def test_fae_trains():
    """`test_fae.py::test_fae_trains[local]`: 4 epochs of 64 steps from
    the port's own init; the hybrid case is
    `tests/test_torch_fae_hybrid.py::test_fae_trains_hybrid_matches_jax`."""
    cfg = HeraldConfig(model="wdl_criteo", batch_size=32, embedding_dim=8,
                       learning_rate=0.5)
    rows = 2000
    eng = FaeEngine(cfg, table_rows=rows, hot_rate=0.05, device="cpu")
    assert eng.num_hot == 100
    dense, sparse, labels = synthetic_ctr_data(get_model("wdl_criteo").spec,
                                               2048, seed=12, num_rows=rows)
    lut, _ = build_hot_lut(sparse, rows, num_hot=eng.num_hot)
    state = eng.init_fae_state(0)
    assert isinstance(state, FaeTrainState)
    losses = []
    for _ in range(4):
        for t in range(len(sparse) // 32):
            sl = slice(t * 32, (t + 1) * 32)
            state, stats = eng.train_step_fae(state, lut, dense[sl],
                                              sparse[sl], labels[sl])
            losses.append(float(stats["loss"]))
    assert np.isfinite(losses).all()
    res = eng.evaluate_fae(state, lut, dense, sparse, labels)
    assert res["auc"] > 0.6, res


def test_fae_hot_rows_actually_update():
    cfg = HeraldConfig(model="wdl_criteo", batch_size=32, embedding_dim=8,
                       learning_rate=0.5)
    eng = FaeEngine(cfg, table_rows=2000, num_hot=50, device="cpu")
    dense, sparse, labels = synthetic_ctr_data(get_model("wdl_criteo").spec,
                                               64, seed=13, num_rows=2000)
    lut, hot_ids = build_hot_lut(sparse, 2000, num_hot=50)
    state = eng.init_fae_state(0)
    before = state.hot_table.clone()
    state, _ = eng.train_step_fae(state, lut, dense[:32], sparse[:32],
                                  labels[:32])
    assert float((state.hot_table - before).abs().max()) > 0


# ----------------------------------------------------------------------
# the host parts: LUT, split, sizes, init
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["ties", "zipf", "num_hot_too_large"])
def test_build_hot_lut_and_split_batch_match_jax(case):
    rng = np.random.default_rng(7)
    if case == "ties":      # every id once: ties everywhere, stable order
        ids = rng.permutation(200).reshape(-1, 4)
        kw = {"num_hot": 17}
    elif case == "zipf":
        ids = (rng.zipf(1.4, (300, 6)) - 1) % 500
        kw = {"hot_rate": 0.03}
    else:
        ids = rng.integers(0, 50, (20, 3))
        kw = {"num_hot": 400}
    rows = 500
    lut, hot = build_hot_lut(ids, rows, **kw)
    jlut, jhot = jax_build_hot_lut(ids, rows, **kw)
    np.testing.assert_array_equal(lut, jlut)
    np.testing.assert_array_equal(hot, jhot)
    assert lut.dtype == np.int32
    jeng = JaxFaeEngine(JaxConfig(model="wdl_criteo", batch_size=4,
                                  embedding_dim=8), table_rows=rows)
    eng = FaeEngine(HeraldConfig(model="wdl_criteo", batch_size=4,
                                 embedding_dim=8), table_rows=rows,
                    device="cpu")
    for a, b in zip(eng.split_batch(lut, ids), jeng.split_batch(lut, ids)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.int32


def test_num_hot_counts_logical_rows_and_init_shapes():
    # 1% of the 33,762,577 logical rows (padded to 33,762,584): 337,625;
    # the engine allocates nothing before init_fae_state
    cfg = HeraldConfig(model="fae_wdl_criteo", batch_size=4, embedding_dim=8)
    full = FaeEngine(cfg, table_rows=33_762_577, device="cpu")
    assert (full.num_hot, full.padded_rows) == (337_625, 33_762_584)
    jeng = JaxFaeEngine(JaxConfig(model="wdl_criteo", batch_size=4,
                                  embedding_dim=8, optimizer="adam",
                                  table_dtype=jnp.bfloat16), table_rows=1001)
    cfg = HeraldConfig(model="wdl_criteo", batch_size=4, embedding_dim=8,
                       optimizer="adam", table_dtype=torch.bfloat16)
    eng = FaeEngine(cfg, table_rows=1001, device="cpu")
    assert eng.num_hot == jeng.num_hot == 10
    assert eng.padded_rows == 1008
    st, jst = eng.init_fae_state(3), jeng.init_fae_state(3)
    assert st.hot_table.shape == jst.hot_table.shape == (10, eng.width)
    assert st.hot_table.dtype == torch.bfloat16
    assert set(st.hot_slots) == set(jst.hot_slots) == {"m", "v"}
    assert all(v.dtype == torch.float32 and v.shape == (10, eng.width)
               and not v.any() for v in st.hot_slots.values())
    # 0.01 * N(0, 1) from seed + 7, reproducible from the seed
    again = eng.init_fae_state(3)
    assert torch.equal(st.hot_table, again.hot_table)
    assert 0.005 < float(st.hot_table.float().std()) < 0.02
    assert not torch.equal(st.hot_table[:, :4],
                           st.table[:10, :4])


def test_bridge_carries_the_fae_state_both_ways():
    """JAX's FaeTrainState -> the port's (not a CachedTrainState) -> host
    arrays whose bf16 leaves are JAX's bit patterns."""
    _, jst, _, st = _pair(opt="adam", dt="bf16")
    assert type(st) is FaeTrainState and not hasattr(st, "cache")
    assert st.hot_table.dtype == torch.bfloat16
    back = state_to_numpy(st)
    assert type(back) is FaeTrainState
    for mine, theirs in ((back.table, jst.table),
                         (back.hot_table, jst.hot_table)):
        assert mine.dtype == np.dtype("V2")
        np.testing.assert_array_equal(
            mine.view(np.uint16), np.asarray(theirs).view(np.uint16))
    assert set(back.hot_slots) == set(jst.hot_slots) == {"m", "v"}
    for k in jst.hot_slots:
        assert st.hot_slots[k].dtype == torch.float32
        np.testing.assert_array_equal(back.hot_slots[k],
                                      np.asarray(jst.hot_slots[k]))


def test_no_card_raises_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = HeraldConfig(model="fae_wdl_criteo", batch_size=4,
                       embedding_dim=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        FaeEngine(cfg, table_rows=100)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run_training(cli.build_parser().parse_args(
            ["--model", "fae_wdl_criteo", "--samples", "200", "--rows",
             "100", "--batch-size", "8", "--embedding-size", "8"]))
    assert FaeEngine(cfg, table_rows=100, device="cpu").device.type == "cpu"


# ----------------------------------------------------------------------
# step and eval parity
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam"])
@pytest.mark.parametrize("model", ["fae_wdl_criteo", "fae_dfm_avazu"])
def test_fae_steps_match_jax(model, opt, dt):
    lr = 1e-3 if (model == "fae_dfm_avazu" and opt == "adam") else LR
    jeng, jst, eng, st = _pair(model, opt, dt, lr)
    spec = get_model(model).spec
    d, s, y = synthetic_ctr_data(spec, B * STEPS, seed=3, num_rows=ROWS)
    lut, _ = build_hot_lut(s, ROWS, num_hot=eng.num_hot)
    share = float((lut[s] >= 0).mean())
    assert 0.2 < share < 0.95, share       # both paths carry traffic
    for i in range(STEPS):
        sl = slice(i * B, (i + 1) * B)
        jst, jstats = jeng.train_step_fae(jst, lut, d[sl], s[sl], y[sl])
        st, stats = eng.train_step_fae(st, lut, d[sl], s[sl], y[sl])
        tol = 1e-6 if dt == "f32" else 1e-5 if opt == "sgd" else 1e-3
        assert abs(float(stats["loss"]) - float(jstats["loss"])) <= tol, i
        assert int(stats["overflow"]) == 0
    assert int(st.step) == int(jst.step) == STEPS
    assert st.hot_table.dtype == st.table.dtype == {
        "f32": torch.float32, "bf16": torch.bfloat16}[dt]
    normalised = opt != "sgd"
    pairs = [(st.table, jst.table), (st.hot_table, jst.hot_table)]
    pairs += [(st.table_slots[k], jst.table_slots[k]) for k in jst.table_slots]
    for got, want in pairs:
        got, want = _f32(got), _f32(want)
        if dt == "f32":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        elif not normalised:
            np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                       atol=2 ** -13)
        else:
            beyond = np.abs(got - want) > 2 ** -6 * np.abs(want) + 2 ** -13
            assert beyond.mean() <= 0.01, beyond.sum()
            np.testing.assert_allclose(got, want, rtol=0, atol=2 * lr)
    assert set(st.hot_slots) == set(jst.hot_slots)
    for k in jst.hot_slots:
        assert st.hot_slots[k].dtype == torch.float32
        want = np.asarray(jst.hot_slots[k])
        scale = max(float(np.abs(want).max()), 1e-30)
        got = st.hot_slots[k].numpy()
        np.testing.assert_allclose(
            got, want, rtol=0, atol=(1e-5 if dt == "f32" else 1e-2) * scale)
    for k in jst.dense:
        got, want = st.dense[k].numpy(), np.asarray(jst.dense[k])
        if dt == "bf16":
            np.testing.assert_allclose(got, want, rtol=0, atol=2 * lr)
        elif not normalised:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        else:
            assert (np.abs(got - want) > 1e-5).mean() <= 1e-3
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    ev, jev = (e.evaluate_fae(x, lut, d, s, y)
               for e, x in ((eng, st), (jeng, jst)))
    assert abs(ev["auc"] - jev["auc"]) <= (1e-4 if dt == "f32" else 0.02)


def test_evaluate_fae_scores_whole_batches_only():
    """A tail shorter than a batch is not scored, as in JAX: 100 samples
    at batch 16 score 96, and equal the scores of the first 96."""
    jeng, jst, eng, st = _pair()
    d, s, y = synthetic_ctr_data(get_model("wdl_criteo").spec, 100, seed=4,
                                 num_rows=ROWS)
    y = y.copy()
    y[96:] = 1 - y[96:]              # a tail that would move the AUC
    lut, _ = build_hot_lut(s, ROWS, num_hot=eng.num_hot)
    got = eng.evaluate_fae(st, lut, d, s, y)
    want = jeng.evaluate_fae(jst, lut, d, s, y)
    head = eng.evaluate_fae(st, lut, d[:96], s[:96], y[:96])
    assert got == head
    assert abs(got["auc"] - want["auc"]) <= 1e-6
    assert got["acc"] == want["acc"]
    short = eng.evaluate_fae(st, lut, d[:10], s[:10], y[:10])
    assert short["auc"] == 0.5 == jeng.evaluate_fae(
        jst, lut, d[:10], s[:10], y[:10])["auc"]


# ----------------------------------------------------------------------
# the kernels' parts of the step, against the Pallas kernels
# ----------------------------------------------------------------------

def _read_case(dt, zeros=True):
    """A state whose cold table and hot block hold -0.0 in some rows, and
    ids with hot and cold positions."""
    jeng, jst, eng, st = _pair(dt=dt, hot_rate=0.1)
    H, R = eng.num_hot, eng.num_rows
    rng = np.random.default_rng(5)
    if zeros:
        neg_hot = rng.choice(H, 20, replace=False)
        neg_cold = rng.choice(R, 100, replace=False)
        st.hot_table[neg_hot] = -0.0
        st.table[neg_cold] = -0.0
    ids = rng.integers(0, R, (B, 26))
    lut, _ = build_hot_lut(np.concatenate([ids.reshape(-1),
                                           np.arange(R)]), R, num_hot=H)
    if zeros:
        # the -0.0 hot rows are read, as are -0.0 cold rows
        inv_lut = np.full(H, -1)
        inv_lut[lut[lut >= 0]] = np.flatnonzero(lut >= 0)
        ids[0, :20] = inv_lut[neg_hot]
        ids[1, :26] = np.setdiff1d(neg_cold, inv_lut)[:26]
    cold, hot_idx = eng.split_batch(lut, ids)
    return eng, st, cold, hot_idx


def _jax_read(st, cold, hot_idx, hot_read):
    """JAX's FAE read (`fae.py:98-106`): the cold fill read, the hot read
    given by `hot_read`, `where`."""
    jt = jnp.asarray(_f32(st.table)).astype(
        jnp.bfloat16 if st.table.dtype == torch.bfloat16 else jnp.float32)
    jh = jnp.asarray(_f32(st.hot_table)).astype(jt.dtype)
    R, H = jt.shape[0], jh.shape[0]
    cold_emb = jt.at[jnp.where(cold >= 0, cold, R + 1).reshape(-1)].get(
        mode="fill", fill_value=0)
    safe = jnp.where(hot_idx >= 0, hot_idx, H + 1).reshape(-1)
    hot_emb = hot_read(jh, safe)
    is_hot = (hot_idx >= 0).reshape(-1, 1)
    return np.asarray(jnp.where(is_hot, hot_emb.astype(jnp.float32),
                                cold_emb.astype(jnp.float32)))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_hot_read_matches_jax_and_pallas(dt):
    """The port's read (K1 by position, then K4's add form) against JAX's
    fill read + `where` bit for bit, but for -0.0 hot rows, which read
    +0.0; and against the Pallas kernel in interpret mode + `where`
    (exact for bf16, within tests/test_pallas_kernels.py's 1e-6 for
    f32)."""
    eng, st, cold, hot_idx = _read_case(dt)
    got = eng._fae_read(st, torch.as_tensor(cold),
                        torch.as_tensor(hot_idx)).reshape(-1, eng.width)
    got = got.numpy()
    want = _jax_read(st, cold, hot_idx,
                     lambda h, ids: h.at[ids].get(mode="fill", fill_value=0))
    gbits, wbits = got.view(np.int32), want.view(np.int32)
    flip = gbits != wbits
    is_hot = np.broadcast_to((hot_idx >= 0).reshape(-1, 1), got.shape)
    hot_neg_zero = is_hot & (wbits == np.int32(-2 ** 31))
    assert hot_neg_zero.sum() >= 20 * eng.width // 2
    # the kept bits: +0.0 where JAX's where keeps a hot -0.0, all else equal
    np.testing.assert_array_equal(flip, hot_neg_zero)
    assert (gbits[hot_neg_zero] == 0).all()
    cold_neg_zero = ~is_hot & (wbits == np.int32(-2 ** 31))
    assert cold_neg_zero.any() and (gbits[cold_neg_zero] == wbits[
        cold_neg_zero]).all()
    np.testing.assert_array_equal(got, want)         # -0.0 == +0.0
    pallas = _jax_read(st, cold, hot_idx,
                       lambda h, ids: pallas_hot_gather(h, ids,
                                                        interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=0,
                               atol=0 if dt == "bf16" else 1e-6)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_hot_grad_sum_matches_jax_and_pallas(dt):
    """K3 with num_rows = H on the raw hot_idx (-1 dropped) against JAX's
    `segment_sum(where(is_hot, g, 0), where(hot >= 0, hot, H), H + 1)[:H]`
    and the Pallas push kernel in interpret mode, within f32 summation
    order (1e-6 of the sum of |g|)."""
    eng, _, _, hot_idx = _read_case(dt, zeros=False)
    hot_idx = hot_idx[:4]           # 104 positions: some hot rows unread
    H, W = eng.num_hot, eng.width
    rng = np.random.default_rng(6)
    g = rng.standard_normal((hot_idx.size, W)).astype(np.float32)
    flat = hot_idx.reshape(-1)
    got = hot_onehot_push(torch.as_tensor(flat), torch.as_tensor(g),
                          H).numpy()
    is_hot = (flat >= 0)[:, None]
    want = np.asarray(jax.ops.segment_sum(
        jnp.where(is_hot, g, 0.0), jnp.where(flat >= 0, flat, H),
        num_segments=H + 1)[:H])
    pallas = np.asarray(pallas_hot_push(jnp.asarray(flat), jnp.asarray(g),
                                        H, interpret=True))
    tol = 1e-6 * float(np.abs(g).sum(axis=0).max())
    assert got.shape == (H, W) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=tol)
    untouched = np.setdiff1d(np.arange(H), flat[flat >= 0])
    assert untouched.size and not got[untouched].any()


# ----------------------------------------------------------------------
# the launcher's FAE branch
# ----------------------------------------------------------------------

LROWS = 3000
COMMON = ["--batch-size", "16", "--embedding-size", "8", "--samples",
          "1600", "--rows", str(LROWS), "--val-ratio", "0.2", "--seed", "5",
          "--lr", "0.5", "--nepoch", "2"]


@pytest.fixture
def _no_jax_compile_cache(monkeypatch):
    monkeypatch.setenv("HERALD_COMPILE_CACHE", "")


@pytest.mark.parametrize("argv", [["--model", "fae_wdl_criteo"],
                                  ["--model", "wdl_criteo", "--fae",
                                   "--hot-rate", "0.02", "--bf16-table"]],
                         ids=["fae_model", "fae_flag_bf16"])
def test_fae_launcher_matches_jax(argv, monkeypatch, _no_jax_compile_cache):
    captured = {}
    orig = JaxFaeEngine.init_fae_state

    def jax_init(self, seed=None):
        captured["state"] = jax.tree.map(np.asarray, orig(self, seed))
        return orig(self, seed)

    monkeypatch.setattr(JaxFaeEngine, "init_fae_state", jax_init)
    jx = jax_run(jax_parser().parse_args(COMMON + ["--no-prefetch"] + argv))
    monkeypatch.setattr(FaeEngine, "init_fae_state",
                        lambda self, seed=None: state_from_numpy(
                            captured["state"], self.device))
    port = cli.run_training(cli.build_parser().parse_args(
        COMMON + ["--device", "cpu"] + argv))
    assert set(port) == set(jx) | {"device"} and port["device"] == "cpu"
    assert port["mode"] == jx["mode"] == "fae"
    hot_rate = 0.02 if "--hot-rate" in argv else 0.01
    assert port["num_hot"] == jx["num_hot"] == int(LROWS * hot_rate)
    assert port["steps"] == jx["steps"] == 2 * (1280 // 16)
    assert abs(port["train_loss_last"] - jx["train_loss_last"]) <= 1e-5
    assert abs(port["val_auc"] - jx["val_auc"]) <= 1e-4
    assert len(port["epochs"]) == len(jx["epochs"]) == 2
    for a, b in zip(port["epochs"], jx["epochs"]):
        assert a["epoch"] == b["epoch"]
        assert abs(a["train_loss"] - b["train_loss"]) <= 1e-5
        assert abs(a["val_auc"] - b["val_auc"]) <= 1e-4


def test_fae_launcher_ignores_ckpt_resume_and_max_steps(tmp_path):
    """As the JAX branch does (it returns before any checkpoint): every
    step of every epoch runs and nothing is written."""
    rep = cli.run_training(cli.build_parser().parse_args(
        COMMON + ["--device", "cpu", "--fae", "--max-steps", "3", "--ckpt",
                  str(tmp_path / "ck"), "--resume", str(tmp_path / "none"),
                  "--log-dir", str(tmp_path / "logs")]))
    assert rep["steps"] == 160 and rep["mode"] == "fae"
    assert not (tmp_path / "ck").exists()
    assert np.load(tmp_path / "logs" / "losses.npy").shape == (160,)
    assert (tmp_path / "logs" / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("argv", [["--fae"], ["--model", "fae_dfm_avazu"]])
def test_fae_export_onnx_exits_with_jax_message(argv, tmp_path,
                                                _no_jax_compile_cache):
    argv = COMMON + argv + ["--export-onnx", str(tmp_path / "m.onnx")]
    with pytest.raises(SystemExit) as port:
        cli.run_training(cli.build_parser().parse_args(
            argv + ["--device", "cpu"]))
    with pytest.raises(SystemExit) as jx:
        jax_run(jax_parser().parse_args(argv))
    assert str(port.value) == str(jx.value)
    assert "--export-onnx does not support FAE runs" in str(port.value)
