"""The port's optimizers and schedules (`herald_tpu_torch/optim/`) against
herald_tpu's, on the same numpy inputs.

- f32 rows: every optimizer's `apply_rows` (with `mask` and `counts`),
  `apply_dense` and `_lamb_dense` within rtol 1e-6 (a few f32 ulps: XLA
  and torch may contract or order the f32 operations differently).
- bf16 rows and slots, with a float32 0-d learning rate (the engine's
  dedup path) and with a Python float: the result dtypes are JAX's at
  every step (rows come back float32 where JAX promotes, slots bf16). The
  bf16 slots, and the rows where they stay bf16, are bit-exact: every op
  rounds to bf16 where XLA's eager CPU ops round, and Python constants are
  rounded to bf16 first, as JAX's weak typing does. Rows promoted to f32
  are within rtol 2.5e-7 (two f32 ulps; measured: 1 of 320 values one
  ulp away for adam). LAMB's row-wise trust ratio sums the squares in f32
  in another order than JAX and rounds the sum to bf16, so it can land one
  bf16 ulp away, moving the update by at most 2^-7 of its size.
- The five schedules against JAX at steps 1..40, rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herald_tpu.optim import get_optimizer as jax_get_optimizer
from herald_tpu.optim import schedules as jax_schedules
from herald_tpu_torch.optim import OPTIMIZERS, get_optimizer
from herald_tpu_torch.optim import schedules

KW = dict(weight_decay=0.01)


def _bf16_torch(a):
    """The bit patterns of a JAX bf16 array as a torch bf16 tensor."""
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _run_rows(name, dtype, steps=4, lr_array=True, counts=False):
    """Steps of apply_rows from identical inputs: after each step the
    port is re-seeded with JAX's result, so every step is compared from
    the same state. Yields (rows before, jax new rows, port new rows, jax
    slots, port slots) per step."""
    rng = np.random.default_rng(2 * OPTIMIZERS.index(name)
                                + (dtype == "bf16"))
    U, D = 40, 8
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    conv = _bf16_torch if dtype == "bf16" else (
        lambda a: torch.from_numpy(np.array(a)))
    rows = jnp.asarray(rng.standard_normal((U, D)) * 0.05, jdt)
    jopt = jax_get_optimizer(name, 0.05, **KW)
    topt = get_optimizer(name, 0.05, **KW)
    jslots = jopt.init_slots(rows)
    mask = np.arange(U) < U - 6                   # padding rows at the end
    cnt = rng.integers(0, 4, U).astype(np.int32) if counts else None
    for t in range(1, steps + 1):
        g = jnp.asarray(rng.standard_normal((U, D)) * 1e-2, jdt)
        jlr = jnp.asarray(0.05, jnp.float32) if lr_array else None
        tlr = torch.tensor(0.05) if lr_array else None
        jn, js = jopt.apply_rows(
            rows, g, jslots, jnp.asarray(t, jnp.int32), lr=jlr,
            counts=None if cnt is None else jnp.asarray(cnt),
            mask=jnp.asarray(mask))
        tn, ts = topt.apply_rows(
            conv(rows), conv(g), {k: conv(v) for k, v in jslots.items()},
            torch.tensor(t, dtype=torch.int32), lr=tlr,
            counts=None if cnt is None else torch.from_numpy(cnt),
            mask=torch.from_numpy(mask))
        yield rows, jn, tn, js, ts
        rows, jslots = jn.astype(jdt), js


@pytest.mark.parametrize("name", OPTIMIZERS)
@pytest.mark.parametrize("counts", [False, True], ids=["plain", "counts"])
def test_apply_rows_f32_matches_jax(name, counts):
    for _, jn, tn, js, ts in _run_rows(name, "f32", counts=counts):
        assert tn.dtype == torch.float32
        # atol: a row that lands near zero keeps the absolute error of a
        # few ulps of the row scale (0.05), 1e-8
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6,
                                   atol=1e-8)
        assert set(ts) == set(js)
        for k in js:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       rtol=1e-6, atol=1e-12)
        # padding rows (mask False) pass through unchanged
        np.testing.assert_array_equal(tn.numpy()[-6:], np.asarray(jn)[-6:])


@pytest.mark.parametrize("name", OPTIMIZERS)
@pytest.mark.parametrize("lr_array", [True, False],
                         ids=["lr_f32", "lr_float"])
def test_apply_rows_bf16_keeps_jax_dtypes_and_bits(name, lr_array):
    for rows, jn, tn, js, ts in _run_rows(name, "bf16", lr_array=lr_array):
        # the dtype-promotion trap: f32 lr array * bf16 grads is f32 in
        # JAX, and so is rows - upd
        assert str(tn.dtype) == f"torch.{jn.dtype}"
        for k in js:
            assert ts[k].dtype == torch.bfloat16
            assert str(js[k].dtype) == "bfloat16"
            # bf16 slots: every op rounds where JAX's rounds
            np.testing.assert_array_equal(_f32(ts[k]), _f32(js[k]))
        got, want = _f32(tn), _f32(jn)
        if name == "lamb":
            # one bf16 ulp of the trust ratio moves the update by at most
            # 2^-7 of its size
            upd = np.abs(_f32(rows) - want).max()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2 ** -7 * upd)
        elif tn.dtype == torch.float32:
            # f32 rows - f32 upd: XLA's f32 division and power may land one
            # f32 ulp of upd away, and the subtraction keeps that absolute
            # error at the scale of the operand rows (about 0.1), not of a
            # result near zero: on hosts whose XLA fuses with FMA, 14 of 320
            # values miss by 2^-27 with |result| < 4e-3. So the absolute
            # tolerance is two f32 ulps of the largest operand.
            atol = 2 * 2 ** -23 * float(np.abs(_f32(rows)).max())
            np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=atol)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_apply_dense_and_lamb_dense_match_jax(name):
    rng = np.random.default_rng(7)
    params = {"W1": rng.standard_normal((13, 16)).astype(np.float32),
              "b1": rng.standard_normal((16,)).astype(np.float32) * 0.1}
    jopt = jax_get_optimizer(name, 0.05, **KW)
    topt = get_optimizer(name, 0.05, **KW)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = {k: jopt.init_slots(v) for k, v in jp.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = {k: topt.init_slots(v) for k, v in tp.items()}
    for t in range(1, 5):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
             for k, v in params.items()}
        step = jnp.asarray(t, jnp.int32)
        jp, js = jopt.apply_dense(jp, {k: jnp.asarray(v) for k, v in
                                       g.items()}, js, step,
                                  lr=jnp.asarray(0.05, jnp.float32))
        tp, ts = topt.apply_dense(tp, {k: torch.from_numpy(v) for k, v in
                                       g.items()}, ts,
                                  torch.tensor(t, dtype=torch.int32),
                                  lr=torch.tensor(0.05))
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-8)
            assert set(ts[k]) == set(js[k])
            for s in js[k]:
                np.testing.assert_allclose(ts[k][s].numpy(),
                                           np.asarray(js[k][s]),
                                           rtol=1e-6, atol=1e-12)
    if name == "lamb":
        # the dense LAMB uses one trust ratio for the whole tensor
        p = torch.ones((4, 8)) * 2.0
        jn, _ = jopt._lamb_dense(jnp.asarray(p.numpy()), jnp.ones((4, 8)),
                                 {"m": jnp.zeros((4, 8)),
                                  "v": jnp.zeros((4, 8))},
                                 jnp.asarray(1, jnp.int32))
        tn, _ = topt._lamb_dense(p, torch.ones((4, 8)),
                                 {"m": torch.zeros((4, 8)),
                                  "v": torch.zeros((4, 8))},
                                 torch.tensor(1, dtype=torch.int32))
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)


def test_apply_dense_takes_both_slot_forms_under_sgd():
    opt = get_optimizer("sgd", 0.5)
    params = {"W1": torch.ones(2, 2), "W2": torch.ones(3)}
    grads = {"W1": torch.ones(2, 2), "W2": torch.ones(3)}
    step = torch.tensor(1, dtype=torch.int32)
    a, sa = opt.apply_dense(params, grads, {}, step)
    b, sb = opt.apply_dense(params, grads, {"W1": {}, "W2": {}}, step)
    assert sa == sb == {"W1": {}, "W2": {}}      # JAX's tree form
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["W1"], torch.full((2, 2), 0.5))


SCHEDULES = [
    ("constant", {}),
    ("step", {"step_size": 7, "gamma": 0.5}),
    ("multistep", {"milestones": [3, 11, 20]}),
    ("exp", {"gamma": 0.93}),
    ("cosine", {"total_steps": 30}),
]


@pytest.mark.parametrize("name,kw", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedules_match_jax(name, kw):
    jf = jax_schedules.get_schedule(name, 0.05, **kw)
    tf = schedules.get_schedule(name, 0.05, **kw)
    for step in range(1, 41):
        want = jf(jnp.asarray(step, jnp.int32))
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert str(want.dtype) == "float32"
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_reduce_on_plateau_matches_jax():
    j = jax_schedules.ReduceOnPlateau(0.1, patience=2, cooldown=1)
    t = schedules.ReduceOnPlateau(0.1, patience=2, cooldown=1)
    for v in [1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7, 0.8, 0.9]:
        assert t.step(v) == j.step(v)
    assert t.get() == j.get() < 0.1
    with pytest.raises(ValueError):
        schedules.ReduceOnPlateau(0.1, mode="sideways")
