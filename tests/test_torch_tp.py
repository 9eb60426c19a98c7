"""The port's tensor-parallel tower (`Engine(mp_shards > 1)`, the
Megatron tower of `parallel/tp.py` over the (dp, mp) grid of a gloo group
of 4 CPU ranks, `tests/_ranks.py`) against herald_tpu's on the first 4 of
the 8 CPU devices and against the port's local engine, mirroring
`tests/test_tp.py`.

One spawn of 4 ranks (`_tp_rank`, torch only) runs every job the test
process prepares from JAX's states:
- train: from one JAX TP state (`bridge.shard_state` cuts its table into
  the ranks' blocks and its tower into their shards), 4 steps of the
  port's TP engine: wdl_criteo at (dp, mp) = (2, 2) and (1, 4), dfm,
  dcn and emb_sum_wdl at (2, 2) by `train_step`, wdl at (2, 2) by
  `train_epoch`, dfm with adam (at lr 1e-3, as `tests/test_torch_hybrid.py`
  runs it across the packages: at JAX's 0.01 adam's normalised step
  turns 1e-7 differences of a near-zero grad into 1e-6 moves of a row).
  Held to JAX's TP engine over the same
  global batches and to the port's local engine from the same logical
  state: losses within rtol 1e-5, the logical table, the dense params
  and their slots within rtol 1e-4, atol 1e-6; `predict` within atol
  1e-6 and the AUC of `evaluate` within 1e-6 of the local engine's (JAX's
  test holds its TP evaluation to its local engine's the same way).
- checkpoints: JAX's TP checkpoint restored by the port at mp = 2 and at
  mp = 1 (the same S), the port's TP checkpoint restored by the port at
  both and by JAX into its TP and its dp engine, all bit for bit; one
  step from the mp = 1 and the mp = 2 restore gives one loss.
- the TP state's ONNX export (`export_state` gathers the tower).
- the collective bytes of one TP step and one mp = 1 step at S = 4,
  and of one TP step over a bf16 table.
- the `tp.py` helpers' values and vector-Jacobian products against
  JAX's `jax.vjp` of the same helper under `shard_map` on a (2, 2) mesh.
- `apply_tp` over the shards against `apply` of the whole tower.
"""

import copy

import numpy as np
import pytest
import torch

from _ranks import run_ranks
from herald_tpu_torch import HeraldConfig
from herald_tpu_torch.bridge import (join_states, shard_state,
                                     state_from_numpy, state_to_numpy)
from herald_tpu_torch.models import get_model
from herald_tpu_torch.parallel import tp
from herald_tpu_torch.train.engine import Engine, TrainState

S, ROWS, B, STEPS = 4, 4096, 16, 4
# (model, mp, optimizer, lr, entry point)
CASES = [("wdl_criteo", 2, "sgd", 0.1, "step"),
         ("wdl_criteo", 4, "sgd", 0.1, "step"),
         ("dfm_criteo", 2, "sgd", 0.1, "step"),
         ("dcn_criteo", 2, "sgd", 0.1, "step"),
         ("emb_sum_wdl_criteo", 2, "sgd", 0.1, "step"),
         ("wdl_criteo", 2, "sgd", 0.1, "epoch"),
         ("dfm_criteo", 2, "adam", 1e-3, "step")]
CKPT_CASE = CASES[0]
TOL = dict(rtol=1e-4, atol=1e-6)
HELPER_B, HELPER_K, HELPER_N = 6, 8, 4


def _name(case):
    return "-".join(str(c) for c in case)


def _cfg(mname, mp, opt="sgd", lr=0.1, cap=8.0, **kw):
    return dict(model=mname, batch_size=B, embedding_dim=8,
                comm_mode="hybrid", optimizer=opt, learning_rate=lr,
                a2a_capacity_factor=cap, mp_shards=mp, **kw)


def _data(mname, seed=3, steps=STEPS):
    from herald_tpu_torch.data import synthetic_ctr_data
    return synthetic_ctr_data(get_model(mname).spec, S * B * steps,
                              seed=seed, num_rows=ROWS)


def _helper_inputs(rank):
    """Each rank's inputs of the tp.py helpers and their cotangents."""
    rng = np.random.default_rng(100 + rank)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    K, N, Bh = HELPER_K, HELPER_N, HELPER_B
    return {"row_parallel": (r(Bh, K), r(K // 2, N), r(Bh, N)),
            "row_parallel_sharded": (r(Bh, K // 2), r(K // 2, N),
                                     r(Bh, N)),
            "gather_cols": (r(Bh, N // 2), None, r(Bh, N)),
            "gather_batch": (r(Bh, N), None, r(2 * Bh, N)),
            "my_batch_chunk": (r(2 * Bh, N), None, r(Bh, N))}


# ---------------------------------------------------------------------------
# the ranks (torch only)
# ---------------------------------------------------------------------------
def _load_state(path):
    return TrainState(**torch.load(path, weights_only=False))


def _snap(st):
    """The state as host arrays of its own (on the CPU `state_to_numpy`
    shares the tensors' memory, which later steps update in place)."""
    return copy.deepcopy(state_to_numpy(st))


def _train(job, rank):
    eng = Engine(HeraldConfig(**job["cfg"]), table_rows=ROWS, device="cpu")
    st = _load_state(job["init"][rank])
    d, s, y = job["data"]
    gb = S * B
    if job["entry"] == "epoch":
        st, stats = eng.train_epoch(st, d, s, y, steps=STEPS)
        losses, overflow = stats["loss"].tolist(), stats["overflow"].tolist()
    else:
        losses, overflow = [], []
        for t in range(STEPS):
            z = slice(t * gb, (t + 1) * gb)
            st, stats = eng.train_step(st, d[z], s[z], y[z])
            losses.append(float(stats["loss"]))
            overflow.append(int(stats["overflow"]))
    return eng, st, {"losses": losses, "overflow": overflow,
                     "state": _snap(st),
                     "predict": eng.predict(st, d[:gb], s[:gb]).numpy(),
                     "auc": eng.evaluate(st, d, s, y)["auc"]}


def _same(a: TrainState, b: TrainState) -> bool:
    return torch.equal(a.table, b.table) and int(a.step) == int(b.step) \
        and all(torch.equal(a.dense[k], b.dense[k]) for k in a.dense) \
        and all(torch.equal(a.dense_slots[k][n], b.dense_slots[k][n])
                for k in a.dense_slots for n in a.dense_slots[k])


def _checkpoints(job, rank, eng_tp, st_tp, out):
    """The checkpoint cases of the module docstring on this rank."""
    from herald_tpu_torch.train.checkpoint import (load_checkpoint,
                                                   save_checkpoint)
    eng_dp = Engine(HeraldConfig(**{**job["cfg"], "mp_shards": 1}),
                    table_rows=ROWS, device="cpu")
    res = {}
    save_checkpoint(st_tp, str(out / "port_tp"), comm=eng_tp.comm,
                    tp=eng_tp.tp_layout)
    back = load_checkpoint(str(out / "port_tp"), "cpu",
                           eng_tp.padded_rows, eng_tp.comm,
                           tp=eng_tp.tp_layout)
    res["port_same_mesh"] = _same(back, st_tp)
    res["port_to_dp"] = _snap(load_checkpoint(
        str(out / "port_tp"), "cpu", eng_dp.padded_rows, eng_dp.comm))
    jax_tp = load_checkpoint(str(out / "jax_tp"), "cpu", eng_tp.padded_rows,
                             eng_tp.comm, tp=eng_tp.tp_layout)
    jax_dp = load_checkpoint(str(out / "jax_tp"), "cpu", eng_dp.padded_rows,
                             eng_dp.comm)
    res["jax_to_tp"] = _snap(jax_tp)
    res["jax_to_dp"] = _snap(jax_dp)
    d, s, y = job["data"]
    gb = S * B
    _, a = eng_dp.train_step(jax_dp, d[:gb], s[:gb], y[:gb])
    _, b = eng_tp.train_step(jax_tp, d[:gb], s[:gb], y[:gb])
    res["continue_losses"] = (float(a["loss"]), float(b["loss"]))
    return res


def _bytes(rank):
    """Counted bytes of one step by kind: {(mp, table dtype): ...} at
    mp 1 and 2 over an f32 table, and at mp 2 over a bf16 one."""
    from herald_tpu_torch.utils.hlo_stats import collective_bytes
    res = {}
    for mp, dt in ((1, torch.float32), (2, torch.float32),
                   (2, torch.bfloat16)):
        eng = Engine(HeraldConfig(**_cfg("wdl_criteo", mp, cap=4.0,
                                         table_dtype=dt)),
                     table_rows=ROWS, device="cpu")
        res[mp, str(dt)] = {"bytes": collective_bytes(
            eng._train_step_body, eng.init_state(0),
            *eng.example_step_args(), comm=eng.comm),
            "capacity": eng.exchange.capacity}
    return res


def _helpers(rank, mp_comm):
    res = {}
    for name, (x, w, ct) in _helper_inputs(rank).items():
        xt = torch.from_numpy(x).requires_grad_(True)
        wt = None if w is None else torch.from_numpy(w).requires_grad_(True)
        fn = getattr(tp, name)
        with torch.enable_grad():
            y = fn(xt, wt, mp_comm) if wt is not None else (
                fn(xt, HELPER_B, mp_comm) if name == "my_batch_chunk"
                else fn(xt, mp_comm))
            grads = torch.autograd.grad(
                y, [t for t in (xt, wt) if t is not None],
                torch.from_numpy(ct))
        res[name] = [y.detach().numpy()] + [g.numpy() for g in grads]
    return res


def _apply_tp(mp_comm):
    res = {}
    for mname in ("wdl_criteo", "dfm_criteo", "dcn_criteo",
                  "emb_sum_wdl_criteo"):
        model = get_model(mname)
        gen = torch.Generator().manual_seed(0)
        params = model.init_dense(gen, 8)
        W = model.emb_width(8)
        emb = 0.1 * torch.randn((32, model.spec.num_sparse, W),
                                generator=gen)
        dense = torch.randn((32, max(model.spec.num_dense, 0)),
                            generator=gen)
        mine = {k: torch.as_tensor(v) for k, v in tp.cut(
            params, model.tp_plan, mp_comm.size, mp_comm.rank).items()}
        with torch.no_grad():
            res[mname] = (model.apply(params, emb, dense).numpy(),
                          model.apply_tp(mine, emb, dense, mp_comm).numpy())
    return res


def _tp_rank(rank, S_, init, out):
    torch.set_num_threads(1)
    from herald_tpu_torch.parallel import comm as C
    C.setup("cpu", init_method=init, rank=rank, world_size=S_)
    jobs = torch.load(out / "jobs.pt", weights_only=False)
    res = {"train": {}}
    for job in jobs["train"]:
        eng, st, r = _train(job, rank)
        res["train"][job["name"]] = r
        if job["name"] == _name(CKPT_CASE):
            res["ckpt"] = _checkpoints(job, rank, eng, st, out)
            from herald_tpu_torch.onnx import export_state
            export_state(eng, st, str(out / "tp.onnx"), batch_size=S * B)
    res["bytes"] = _bytes(rank)
    eng = Engine(HeraldConfig(**_cfg("wdl_criteo", 2)), table_rows=ROWS,
                 device="cpu")
    res["helpers"] = _helpers(rank, eng.mp_comm)
    res["apply_tp"] = _apply_tp(eng.mp_comm)
    torch.save(res, out / f"tp.r{rank}.pt")


# ---------------------------------------------------------------------------
# the test process: JAX's side, the port's local engine
# ---------------------------------------------------------------------------
def _jax_engine(mname, mp, opt="sgd", lr=0.1, cap=8.0, **kw):
    import jax
    from herald_tpu import HeraldConfig as JaxConfig
    from herald_tpu.train.engine import Engine as JaxEngine
    cfg = JaxConfig(**_cfg(mname, mp, opt, lr, cap, **kw))
    return JaxEngine(cfg, mesh=cfg.make_mesh(jax.devices()[:S]),
                     table_rows=ROWS)


def _np_tree(state):
    import jax
    return jax.tree.map(np.asarray, state)


def _local_run(case, init_np, spec, data):
    """The port's local engine from the JAX TP state's logical table and
    tower, over the same global batches."""
    mname, _, opt, lr, _ = case
    eng = Engine(HeraldConfig(model=mname, batch_size=S * B,
                              embedding_dim=8, optimizer=opt,
                              learning_rate=lr), table_rows=ROWS,
                 device="cpu")
    logical = init_np._replace(
        table=spec.to_logical(init_np.table),
        table_slots={k: spec.to_logical(v)
                     for k, v in init_np.table_slots.items()})
    st = state_from_numpy(logical, "cpu")
    st, stats = eng.train_epoch(st, *data, steps=STEPS)
    d, s, y = data
    return {"losses": stats["loss"].tolist(), "state": state_to_numpy(st),
            "predict": eng.predict(st, d[:S * B], s[:S * B]).numpy(),
            "auc": eng.evaluate(st, d, s, y)["auc"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    from herald_tpu.train.checkpoint import save_checkpoint as jax_save
    out = tmp_path_factory.mktemp("tp")
    jobs, jax_res, local = {"train": []}, {}, {}
    for case in CASES:
        mname, mp, opt, lr, entry = case
        name = _name(case)
        jeng = _jax_engine(mname, mp, opt, lr)
        st = jeng.init_state(0)
        init_np = _np_tree(st)
        data = _data(mname)
        for r in range(S):
            torch.save(shard_state(init_np, jeng.exchange, r, "cpu",
                                   get_model(mname).tp_plan, mp)._asdict(),
                       out / f"init.{name}.r{r}.pt")
        jobs["train"].append({
            "name": name, "cfg": _cfg(mname, mp, opt, lr), "entry": entry,
            "data": data, "init": [out / f"init.{name}.r{r}.pt"
                                   for r in range(S)]})
        local[name] = _local_run(case, init_np, jeng.exchange, data)
        if case == CKPT_CASE:
            # JAX's checkpoint of its TP state after one step
            st1, _ = jeng.train_epoch(jax.tree.map(lambda a: a, st),
                                      *(a[:S * B] for a in data), steps=1)
            jax_save(st1, str(out / "jax_tp"))
            jax_res["ckpt_state"] = _np_tree(st1)
            st = jeng.init_state(0)
        st, stats = jeng.train_epoch(st, *data, steps=STEPS)
        jax_res[name] = {
            "losses": np.asarray(stats["loss"]).tolist(),
            "overflow": np.asarray(stats["overflow"]).tolist(),
            "state": _np_tree(st), "spec": jeng.exchange}
    torch.save(jobs, out / "jobs.pt")
    run_ranks(_tp_rank, S, out, out, timeout=300.0)
    ranks = [torch.load(out / f"tp.r{r}.pt", weights_only=False)
             for r in range(S)]
    return {"out": out, "ranks": ranks, "jax": jax_res, "local": local}


def _joined(runs, name, mp):
    model = name.split("-")[0]
    return join_states([r["train"][name]["state"] for r in runs["ranks"]],
                       get_model(model).tp_plan, mp)


def _close_states(got, want, spec_got, spec_want, what):
    np.testing.assert_allclose(spec_got.to_logical(got.table),
                               spec_want.to_logical(want.table), **TOL,
                               err_msg=f"{what}: table")
    for k in want.dense:
        np.testing.assert_allclose(got.dense[k], want.dense[k], **TOL,
                                   err_msg=f"{what}: {k}")
        for n in want.dense_slots[k]:
            np.testing.assert_allclose(got.dense_slots[k][n],
                                       want.dense_slots[k][n], **TOL,
                                       err_msg=f"{what}: {k}/{n}")


class _Identity:
    def to_logical(self, a):
        return a[:ROWS]


@pytest.mark.parametrize("case", CASES, ids=_name)
def test_tp_matches_jax_tp_and_local(runs, case):
    name, mp = _name(case), case[1]
    jx, loc = runs["jax"][name], runs["local"][name]
    port = [r["train"][name] for r in runs["ranks"]]
    for p in port:
        np.testing.assert_allclose(p["losses"], jx["losses"], rtol=1e-5)
        np.testing.assert_allclose(p["losses"], loc["losses"], rtol=1e-5)
        assert p["overflow"] == jx["overflow"] == [0] * STEPS
        np.testing.assert_allclose(p["predict"], loc["predict"], atol=1e-6)
        assert abs(p["auc"] - loc["auc"]) < 1e-6
    got = _joined(runs, name, mp)
    _close_states(got, jx["state"], jx["spec"], jx["spec"], "jax")
    _close_states(got, loc["state"], jx["spec"], _Identity(), "local")
    # every rank holds only its shard of each sharded param
    plan = get_model(case[0]).tp_plan
    for r, rk in enumerate(runs["ranks"]):
        dense = rk["train"][name]["state"].dense
        for k, v in tp.cut(got.dense, plan, mp, r % mp).items():
            assert dense[k].shape == v.shape, k


def test_tp_checkpoints_cross_packages_and_topologies(runs):
    """JAX's TP checkpoint restores in the port at mp = 2 and mp = 1, the
    port's in both packages and both layouts, bit for bit."""
    import jax
    from herald_tpu.train.checkpoint import load_checkpoint as jax_load
    name = _name(CKPT_CASE)
    ranks = runs["ranks"]
    plan = get_model(CKPT_CASE[0]).tp_plan
    want = runs["jax"]["ckpt_state"]
    for r, rk in enumerate(ranks):
        c = rk["ckpt"]
        assert c["port_same_mesh"]
        # the JAX checkpoint at mp = 2: this rank's table block and shards
        cut = shard_state(want, runs["jax"][name]["spec"], r, "cpu", plan, 2)
        got = c["jax_to_tp"]
        np.testing.assert_array_equal(got.table, cut.table.numpy())
        for k in want.dense:
            np.testing.assert_array_equal(got.dense[k],
                                          cut.dense[k].numpy())
            # and at mp = 1 the whole tower
            np.testing.assert_array_equal(c["jax_to_dp"].dense[k],
                                          want.dense[k])
        assert int(got.step) == int(want.step) == 1
        np.testing.assert_allclose(*c["continue_losses"], rtol=1e-6)
    # the port's TP checkpoint: at mp = 1 in the port, and in JAX
    port = _joined(runs, name, 2)
    for rk in ranks:
        for k in port.dense:
            np.testing.assert_array_equal(rk["ckpt"]["port_to_dp"].dense[k],
                                          port.dense[k])
    for mp in (2, 1):
        jeng = _jax_engine(CKPT_CASE[0], mp)
        back = _np_tree(jax_load(str(runs["out"] / "port_tp"),
                                 jeng.init_state(1)))
        np.testing.assert_array_equal(back.table, port.table)
        for k in port.dense:
            np.testing.assert_array_equal(back.dense[k], port.dense[k])
        assert int(back.step) == STEPS
        jax.clear_caches()


def test_tp_state_onnx_export(runs):
    """export_state gathers the mp shards; the file scores as `predict`."""
    from herald_tpu_torch.onnx import OnnxModel
    name = _name(CKPT_CASE)
    d, s, _ = _data(CKPT_CASE[0])
    om = OnnxModel.load(str(runs["out"] / "tp.onnx"))
    (probs,) = om(sparse_ids=s[:S * B].astype(np.int64),
                  dense_x=d[:S * B].astype(np.float32))
    np.testing.assert_allclose(probs, runs["ranks"][0]["train"][name]
                               ["predict"], rtol=1e-4, atol=1e-6)


def test_tp_exchange_bytes_match_mp1_and_jax(runs):
    """TP adds no embedding-exchange traffic: the (2, 2) step's counted
    all-to-all bytes equal the mp = 1 step's at the same S and JAX's
    compiled (2, 2) step's."""
    from herald_tpu.utils.hlo_stats import collective_bytes as jax_bytes
    jeng = _jax_engine("wdl_criteo", 2, cap=4.0)
    want = jax_bytes(jeng._train_step, jeng.init_state(0),
                     *jeng.example_step_args())
    f32 = str(torch.float32)
    for rk in runs["ranks"]:
        b1, b2 = rk["bytes"][1, f32], rk["bytes"][2, f32]
        assert b1["capacity"] == b2["capacity"] == jeng.exchange.capacity
        assert b2["bytes"]["all-to-all"] == b1["bytes"]["all-to-all"] \
            == want["all-to-all"], (b1, b2, want)
        # the tower's gathers and reduce-scatters ride the mp group only
        assert b1["bytes"]["all-gather"] == 0
        assert b2["bytes"]["all-gather"] > 0
        assert b2["bytes"]["reduce-scatter"] > 0


def test_tp_bf16_table_gathers_in_its_dtype_like_jax(runs):
    """Over a bf16 table the (2, 2) step gathers the embeddings over mp in
    bf16 and widens them after, as JAX's step does, so its counted
    all-gather, reduce-scatter and all-to-all bytes equal those of JAX's
    step as lowered, and the gathers and reduce-scatters move less than
    over an f32 table (the dense features stay f32 in both). JAX's
    program is read before XLA's passes: the CPU compiler widens every
    bf16 collective to f32, so a compiled count here shows f32 at both
    table dtypes."""
    import jax.numpy as jnp
    from herald_tpu.utils.hlo_stats import parse_collective_bytes
    jeng = _jax_engine("wdl_criteo", 2, cap=4.0, table_dtype=jnp.bfloat16)
    want = parse_collective_bytes(jeng._train_step.lower(
        jeng.init_state(0), *jeng.example_step_args()).as_text(
            dialect="hlo"))
    for rk in runs["ranks"]:
        got = rk["bytes"][2, str(torch.bfloat16)]["bytes"]
        f32 = rk["bytes"][2, str(torch.float32)]["bytes"]
        for kind in ("all-gather", "reduce-scatter", "all-to-all"):
            assert got[kind] == want[kind], (kind, got, want)
        assert got["all-gather"] < f32["all-gather"]
        assert got["reduce-scatter"] < f32["reduce-scatter"]


def test_tp_helper_transposes_match_jax_vjp(runs):
    """Each helper's value and its vjp (psum <-> psum, all_gather <->
    psum_scatter, slice <-> zero-pad) equal JAX's under shard_map
    (check_vma=False) on a (dp, mp) = (2, 2) mesh, rank r = device r."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from herald_tpu.parallel import tp as jtp
    mesh = Mesh(np.array(jax.devices()[:S]).reshape(2, 2), ("dp", "mp"))
    ins = [_helper_inputs(r) for r in range(S)]
    flat = P(("dp", "mp"))
    for name in ins[0]:
        x = np.stack([i[name][0] for i in ins])
        ct = np.stack([i[name][2] for i in ins])
        has_w = ins[0][name][1] is not None
        w = np.stack([i[name][1] for i in ins]) if has_w else x[:, :0]

        def body(x, w, ct, name=name, has_w=has_w):
            fn = getattr(jtp, name)
            if has_w:
                y, vjp = jax.vjp(lambda a, b: fn(a, b, "mp"), x[0], w[0])
                gx, gw = vjp(ct[0])
                return y[None], gx[None], gw[None]
            if name == "my_batch_chunk":
                y, vjp = jax.vjp(lambda a: fn(a, HELPER_B, "mp"), x[0])
            else:
                y, vjp = jax.vjp(lambda a: fn(a, "mp"), x[0])
            (gx,) = vjp(ct[0])
            return y[None], gx[None], gx[None]
        y, gx, gw = jax.jit(jax.shard_map(
            body, mesh=mesh, check_vma=False, in_specs=(flat,) * 3,
            out_specs=(flat,) * 3))(x, w, ct)
        for r, rk in enumerate(runs["ranks"]):
            got = rk["helpers"][name]
            np.testing.assert_allclose(got[0], np.asarray(y[r]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{name} value")
            np.testing.assert_allclose(got[1], np.asarray(gx[r]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{name} dx")
            if has_w:
                np.testing.assert_allclose(got[2], np.asarray(gw[r]),
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=f"{name} dw")


def test_tp_apply_matches_apply_forward(runs):
    for rk in runs["ranks"]:
        for mname, (ref, got) in rk["apply_tp"].items():
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7,
                                       err_msg=mname)


def test_tp_plans_match_jax():
    from herald_tpu.models import available_models as jax_models
    from herald_tpu.models import get_model as jax_model
    for name in jax_models():
        assert get_model(name).tp_plan == jax_model(name).tp_plan, name
        assert (get_model(name).apply_tp is None) == \
            (jax_model(name).apply_tp is None), name


def test_tp_config_validation():
    """JAX's refusals, in the same words (tests/test_tp.py:124-140)."""
    with pytest.raises(ValueError, match="comm_mode"):
        HeraldConfig(model="wdl_criteo", mp_shards=2)
    with pytest.raises(ValueError, match="dp-only"):
        HeraldConfig(model="wdl_criteo", comm_mode="hybrid", mp_shards=2,
                     use_cache=True)
    with pytest.raises(ValueError, match="lamb"):
        HeraldConfig(model="wdl_criteo", comm_mode="hybrid", mp_shards=2,
                     optimizer="lamb")
    with pytest.raises(ValueError, match="dp-only"):
        HeraldConfig(model="wdl_criteo", comm_mode="hybrid", mp_shards=2,
                     dense_sync_every=2)
    cfg = HeraldConfig(model="dc_criteo", comm_mode="hybrid", mp_shards=2)
    with pytest.raises(ValueError, match="no tensor-parallel tower"):
        Engine(cfg, table_rows=ROWS, device="cpu")
    # one rank cannot host mp = 3 (JAX: the mesh cannot)
    cfg = HeraldConfig(model="wdl_criteo", comm_mode="hybrid", mp_shards=3)
    with pytest.raises(ValueError, match="divisible"):
        Engine(cfg, table_rows=ROWS, device="cpu")


def test_fae_engine_refuses_mp_where_jax_runs_over_dp_alone():
    """The port's FaeEngine refuses mp_shards > 1. JAX's builds and runs,
    but its FAE step is sharded over 'dp' alone: its first loss at (2, 2)
    is summed over the 2 dp peers of a loss scaled by 1/4, half the
    mp = 1 engine's (ROADMAP section 3)."""
    import jax
    from herald_tpu import HeraldConfig as JaxConfig
    from herald_tpu.train.fae import FaeEngine as JaxFae
    from herald_tpu.train.fae import build_hot_lut
    from herald_tpu_torch.train.fae import FaeEngine
    with pytest.raises(ValueError, match="FAE engine"):
        FaeEngine(HeraldConfig(**_cfg("wdl_criteo", 2)), table_rows=ROWS,
                  device="cpu")
    d, s, y = _data("wdl_criteo", steps=1)
    losses = {}
    for mp in (1, 2):
        cfg = JaxConfig(**_cfg("wdl_criteo", mp))
        eng = JaxFae(cfg, mesh=cfg.make_mesh(jax.devices()[:S]),
                     table_rows=ROWS)
        lut, _ = build_hot_lut(s, ROWS, num_hot=eng.num_hot)
        _, st = eng.train_step_fae(eng.init_fae_state(0), lut, d, s, y)
        losses[mp] = float(st["loss"])
    np.testing.assert_allclose(losses[2], losses[1] / 2, rtol=1e-5)
