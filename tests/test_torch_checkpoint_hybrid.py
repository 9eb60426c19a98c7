"""Checkpoints over S ranks (`train/checkpoint.py` with a `Comm`: each rank
writes its blocks, rank 0 the rest, LATEST after a barrier) against
herald_tpu's checkpoints of its hybrid engines on the first S of the 8
CPU devices, with gloo ranks spawned through `tests/_ranks.py`.

The test process makes every JAX state and checkpoint first, then spawns
4 ranks once (`_ckpt_rank`: they save a JAX 4-device state's blocks) and
2 ranks once, which save, restore and train; JAX states cross over
through `bridge.shard_state` and come back through `join_states`.
- port -> JAX (S = 2): a plain state (adam on an f32 table; SGD on a
  bf16 one) and a CachedTrainState with a pinned tier, each saved by 2
  port ranks, load in JAX's `load_checkpoint` on a 2-device engine bit
  for bit, and each rank's own restore is the state it saved.
- JAX -> port (S = 2): the same states saved by JAX's one process over 2
  devices restore onto 2 port ranks, each rank's block bit for bit the
  one `shard_state` gives; a rank reads only the blocks that cover its
  rows (one per sharded leaf), at S = 4 too.
- resizes: 2 -> 1 (the port's one-device restore, and JAX's onto a local
  engine), 1 -> 2 (JAX's one-device checkpoint onto 2 ranks) and 4 -> 2:
  the logical table and slots bit for bit JAX's `to_logical`. A cached
  state of another shard count raises, on one device and on 2 ranks.
- 2 steps of the port's hybrid engine from its restore of JAX's
  checkpoint against JAX's 2 steps from its load of the port's, with the
  tolerances of `tests/test_torch_hybrid.py`.
- `serve.load_scorer` on one device scores the 2-rank checkpoint as the
  2-rank engine predicts and evaluates it.
- a rank that fails before writing its shard leaves LATEST where it was.
"""

import copy
import dataclasses
import json
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from _ranks import run_ranks
from herald_tpu_torch import HeraldConfig
from herald_tpu_torch.bridge import join_states, shard_state, state_to_numpy
from herald_tpu_torch.data import synthetic_ctr_data
from herald_tpu_torch.models import get_model
from herald_tpu_torch.parallel import comm as C
from herald_tpu_torch.parallel.exchange import make_exchange
from herald_tpu_torch.train import checkpoint as ckpt
from herald_tpu_torch.train.cached import CachedEngine, CachedTrainState
from herald_tpu_torch.train.engine import Engine, TrainState
from herald_tpu_torch.utils.metrics import auc_score

ROWS, B, STEPS = 1000, 8, 2
SPEC = get_model("wdl_criteo").spec
# name: (optimizer, table dtype, lr)
PLAIN = {"adam-f32": ("adam", "f32", 0.01), "sgd-bf16": ("sgd", "bf16", 0.5)}
CACHED = dict(cache_limit_ratio=0.5, pinned_rows=16)
TAB = {"f32": dict(rtol=0, atol=1e-5),
       "bf16": dict(rtol=2.0 ** -7, atol=2.0 ** -13)}


def _data(n, seed):
    return synthetic_ctr_data(SPEC, n, seed=seed, num_rows=ROWS)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------
@contextmanager
def _recording_reads(reads):
    """Record (file, key) of every array read from a shard file."""
    load = np.load

    class Npz:
        def __init__(self, path):
            self.z, self.name = load(path), str(path).rsplit("/", 1)[-1]

        def __getitem__(self, k):
            reads.append((self.name, k))
            return self.z[k]

        def close(self):
            self.z.close()

    def recording(path, *a, **kw):
        if str(path).rsplit("/", 1)[-1].startswith("shards."):
            return Npz(path)
        return load(path, *a, **kw)
    ckpt.np.load = recording
    try:
        yield
    finally:
        ckpt.np.load = load


def _engine(job):
    cls = CachedEngine if job["cached"] else Engine
    return cls(HeraldConfig.from_json(job["cfg"]), table_rows=ROWS,
               device="cpu")


def _restore(job, eng, comm, reads):
    with _recording_reads(reads):
        if job["cached"]:
            return ckpt.load_cached_checkpoint(job["dir"], "cpu", comm)
        return ckpt.load_checkpoint(job["dir"], "cpu", eng.padded_rows,
                                    comm)


def _save_job(job, comm):
    """Save the rank's state, then restore it into fresh tensors."""
    saved = torch.load(job["state"][comm.rank], weights_only=False)
    st = (CachedTrainState if job["cached"] else TrainState)(**saved)
    ckpt.save_checkpoint(st, job["dir"], comm=comm)
    reads = []
    back = _restore(job, _engine(job), comm, reads)
    same = [(k, torch.equal(a, b)) for (k, a), (_, b)
            in zip(ckpt._leaf_items(st), ckpt._leaf_items(back))]
    return {"round_trip": same, "reads": reads}


def _host(st):
    """A state's fields as host arrays of their own (a CPU tensor's
    `.numpy()` shares its memory, and the steps write in place)."""
    return copy.deepcopy(state_to_numpy(st)._asdict())


def _restore_job(job, comm):
    eng = _engine(job)
    reads = []
    st = _restore(job, eng, comm, reads)
    res = {"state": _host(st), "reads": reads}
    if "eval" in job:
        d, s, y = job["eval"]
        gb = B * comm.size
        res["predict"] = eng.predict(st, d[:gb], s[:gb]).numpy()
        res["evaluate"] = eng.evaluate(st, d, s, y)
    if "train" in job:
        d, s, y = job["train"]
        st, stats = eng.train_epoch(st, d, s, y, steps=STEPS)
        res.update(losses=stats["loss"].tolist(),
                   overflow=stats["overflow"].tolist(), trained=_host(st))
    return res


def _raises_job(job, comm):
    try:
        _restore(job, _engine(job), comm, [])
    except ValueError as e:
        return str(e)
    return None


def _ckpt_rank(rank, S, init, out):
    torch.set_num_threads(1)
    comm = C.setup("cpu", init_method=init, rank=rank, world_size=S)
    jobs = torch.load(out / f"jobs{S}.pt", weights_only=False)
    run = {"save": _save_job, "restore": _restore_job, "raises": _raises_job}
    res = {name: run[job["kind"]](job, comm) for name, job in jobs.items()}
    torch.save(res, out / f"r{rank}.S{S}.pt")


def _failing_rank(rank, S, init, out):
    """Both ranks save at step 2; at step 4 rank 1 fails before writing
    its shard file."""
    comm = C.setup("cpu", init_method=init, rank=rank, world_size=S)
    eng = Engine(HeraldConfig(model="wdl_criteo", batch_size=B,
                              embedding_dim=8, comm_mode="hybrid"),
                 table_rows=ROWS, device="cpu")
    st = eng.init_state(0)
    st.step.fill_(2)
    ckpt.save_checkpoint(st, str(out / "ck"), comm=comm)
    st.step.fill_(4)
    if rank == 1:
        def lost(t):
            raise OSError("the disk went away")
        ckpt.tensor_to_numpy = lost
    ckpt.save_checkpoint(st, str(out / "ck"), comm=comm)


# ---------------------------------------------------------------------------
# the JAX side, in the test process
# ---------------------------------------------------------------------------
def _jax_engine(S, cached=False, opt="adam", dt="f32", lr=0.01, **kw):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from herald_tpu import HeraldConfig as JaxConfig
    from herald_tpu.train.cached import CachedEngine as JaxCachedEngine
    from herald_tpu.train.engine import Engine as JaxEngine
    jcfg = JaxConfig(model="wdl_criteo", batch_size=B, embedding_dim=8,
                     comm_mode="hybrid" if S > 1 else "local",
                     optimizer=opt, learning_rate=lr,
                     table_dtype={"f32": jnp.float32,
                                  "bf16": jnp.bfloat16}[dt],
                     a2a_capacity_factor=8.0, **kw)
    mesh = Mesh(np.array(jax.devices()[:S]), ("dp",))
    cls = JaxCachedEngine if cached else JaxEngine
    return jcfg, cls(jcfg, mesh=mesh, table_rows=ROWS)


def _numpy_state(jst):
    import jax
    return jax.tree.map(np.array, jst)


def _port_cfg(jcfg):
    return HeraldConfig.from_json(jcfg.to_json()).to_json()


def _rank_files(out, name, leaves, spec, S):
    paths = []
    for r in range(S):
        paths.append(out / f"{name}.r{r}.pt")
        torch.save(shard_state(leaves, spec, r, "cpu")._asdict(), paths[-1])
    return paths


def _trained_plain(S, case, seed):
    """A JAX hybrid state after STEPS steps (the slots moved)."""
    opt, dt, lr = PLAIN[case]
    jcfg, jeng = _jax_engine(S, opt=opt, dt=dt, lr=lr)
    jst, _ = jeng.train_epoch(jeng.init_state(0), *_data(S * B * STEPS,
                                                         seed), steps=STEPS)
    return jcfg, jeng, jst


def _trained_cached(S):
    """A JAX CachedTrainState after 3 planned steps (cache, hot block and
    hot slots all moved)."""
    jcfg, jeng = _jax_engine(S, cached=True, opt="sgd", lr=0.5,
                             embed_optimizer="adagrad", **CACHED)
    d, s, y = _data(S * B * 6, 4)
    jst = jeng.init_cached_state(0)
    pl = jeng.make_planner(s, epochs=1, n_threads=1)
    for _ in range(3):
        jst, st = jeng.train_step_cached(jst, pl, d, s, y)
        assert st is not None
    pl.close()
    return jcfg, jeng, jst


def _prepare(out):
    from herald_tpu.train.checkpoint import save_checkpoint as jax_save
    jobs2, jobs4, refs = {}, {}, {}
    for i, case in enumerate(PLAIN):
        jcfg, jeng, jst = _trained_plain(2, case, seed=11 + i)
        leaves = _numpy_state(jst)
        jax_save(jst, str(out / f"jax-{case}"))
        jobs2[f"save-{case}"] = {
            "kind": "save", "cfg": _port_cfg(jcfg), "cached": False,
            "dir": str(out / f"port-{case}"),
            "state": _rank_files(out, case, leaves, jeng.exchange, 2)}
        train, val = _data(2 * B * STEPS, 21), _data(96, 23)
        jobs2[f"restore-{case}"] = {
            "kind": "restore", "cfg": _port_cfg(jcfg), "cached": False,
            "dir": str(out / f"jax-{case}"), "train": train, "eval": val}
        refs[case] = (jcfg, jeng, leaves, train, val)
    jcfg, jeng, jst = _trained_cached(2)
    leaves = _numpy_state(jst)
    jax_save(jst, str(out / "jax-cached"))
    jobs2["save-cached"] = {
        "kind": "save", "cfg": _port_cfg(jcfg), "cached": True,
        "dir": str(out / "port-cached"),
        "state": _rank_files(out, "cached", leaves, jeng.exchange, 2)}
    jobs2["restore-cached"] = {"kind": "restore", "cfg": _port_cfg(jcfg),
                               "cached": True, "dir": str(out / "jax-cached")}
    refs["cached"] = (jcfg, jeng, leaves)
    # a cached state of one device cannot restore onto 2 ranks
    jcfg1, _, jst1 = _trained_cached(1)
    jax_save(jst1, str(out / "jax-cached-1"))
    jobs2["cached-resize"] = {"kind": "raises", "cfg": _port_cfg(jcfg),
                              "cached": True,
                              "dir": str(out / "jax-cached-1")}
    # 1 -> 2: JAX's one-device checkpoint
    jcfg1, jeng1, jst1 = _trained_plain(1, "adam-f32", seed=31)
    jax_save(jst1, str(out / "jax-1"))
    refs["from1"] = _numpy_state(jst1)
    jobs2["from1"] = {"kind": "restore", "cfg": _port_cfg(refs["adam-f32"][0]),
                      "cached": False, "dir": str(out / "jax-1")}
    # 4 -> 2: 4 port ranks save a JAX 4-device state's blocks
    jcfg4, jeng4, jst4 = _trained_plain(4, "adam-f32", seed=41)
    leaves4 = _numpy_state(jst4)
    jobs4["save4"] = {"kind": "save", "cfg": _port_cfg(jcfg4),
                      "cached": False, "dir": str(out / "port-4"),
                      "state": _rank_files(out, "four", leaves4,
                                           jeng4.exchange, 4)}
    refs["from4"] = (jeng4, leaves4)
    jobs2["from4"] = {"kind": "restore", "cfg": _port_cfg(refs["adam-f32"][0]),
                      "cached": False, "dir": str(out / "port-4")}
    torch.save(jobs2, out / "jobs2.pt")
    torch.save(jobs4, out / "jobs4.pt")
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(out dir, the references, {S: each rank's results})."""
    out = tmp_path_factory.mktemp("ckpt_hybrid")
    refs = _prepare(out)
    res = {}
    for S in (4, 2):     # the 2 ranks restore the 4 ranks' checkpoint
        run_ranks(_ckpt_rank, S, out, out, timeout=240)
        res[S] = [torch.load(out / f"r{r}.S{S}.pt", weights_only=False)
                  for r in range(S)]
    return out, refs, res


def _flat(tree, prefix=""):
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items()
                for p, v in _flat(t, f"{prefix}/{k}").items()}
    return {prefix: np.asarray(tree)}


def _bits(a):
    """bf16 (a `V2` array of the port's, ml_dtypes' of JAX's) as its
    16-bit patterns."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.kind == "V" \
        or a.dtype.name == "bfloat16" else a


def _equal_trees(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                      err_msg=k)


def _f32(a):
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["adam-f32", "cached"])
def test_port_save_over_two_ranks_loads_in_jax(ranks, case):
    from herald_tpu.train.checkpoint import load_checkpoint as jax_load
    out, refs, res = ranks
    jeng, leaves = refs[case][1], refs[case][2]
    like = (jeng.init_cached_state(1) if case == "cached"
            else jeng.init_state(1))
    back = _numpy_state(jax_load(str(out / f"port-{case}"), like))
    _equal_trees(back, leaves)


@pytest.mark.parametrize("case", list(PLAIN) + ["cached"])
def test_port_saves_restore_bit_for_bit_on_every_rank(ranks, case):
    _, _, res = ranks
    for r in range(2):
        same = res[2][r][f"save-{case}"]["round_trip"]
        assert same and all(ok for _, ok in same), same


def test_bf16_blocks_are_jaxs_bits(ranks):
    """JAX's loader refuses a row-sharded bf16 leaf, its own included
    (`herald_tpu/train/checkpoint.py:211` assigns the stored `V2` blocks
    into a bfloat16 array: "No cast function available"), so the port's
    2-rank bf16 checkpoint is held to JAX's 2-device one block by block:
    the same 16-bit patterns at the same offsets."""
    from herald_tpu.train.checkpoint import load_checkpoint as jax_load
    out, refs, _ = ranks
    jeng = refs["sgd-bf16"][1]
    with pytest.raises(ValueError, match="No cast function"):
        jax_load(str(out / "jax-sgd-bf16"), jeng.init_state(1))

    def blocks(root, files):
        vdir = root / (root / "LATEST").read_text()
        got = {}
        for p in range(files):
            meta = json.loads((vdir / f"blocks.p{p}.json").read_text())
            with np.load(vdir / f"shards.p{p}.npz") as z:
                for m in meta:
                    got[(m["key"], tuple(map(tuple, m["offsets"])))] = \
                        _bits(z[m["file_key"]])
        return got
    port = blocks(out / "port-sgd-bf16", 2)
    want = blocks(out / "jax-sgd-bf16", 1)
    assert port.keys() == want.keys() and port
    for k in want:
        assert port[k].dtype == np.uint16
        np.testing.assert_array_equal(port[k], want[k], err_msg=str(k))


@pytest.mark.parametrize("case", list(PLAIN) + ["cached"])
def test_port_save_layout_is_jaxs(ranks, case):
    """Rank r's shard file holds one block a sharded leaf at rows
    [r * n, (r + 1) * n); rank 0's manifest names 2 processes, the global
    shapes and the sharded leaves; LATEST names the version."""
    out, refs, _ = ranks
    leaves = refs[case][2]
    root = out / f"port-{case}"
    vdir = root / (root / "LATEST").read_text()
    manifest = json.loads((vdir / "manifest.json").read_text())
    assert manifest["num_processes"] == 2
    sharded = {k for k, v in manifest["layout"].items() if v == "sharded"}
    want = {"table", *(f"table_slots/{k}" for k in leaves.table_slots)}
    if case == "cached":
        want |= {"cache", *(f"hot_slots/{k}" for k in leaves.hot_slots)}
    assert sharded == want
    flat = _flat(leaves)
    for k, shape in manifest["shapes"].items():
        assert tuple(shape) == flat["/" + k].shape, k
    for r in range(2):
        meta = json.loads((vdir / f"blocks.p{r}.json").read_text())
        assert {m["key"] for m in meta} == want
        with np.load(vdir / f"shards.p{r}.npz") as z:
            for m in meta:
                n = manifest["shapes"][m["key"]][0] // 2
                assert m["offsets"][0] == [r * n, (r + 1) * n]
                assert z[m["file_key"]].shape[0] == n


@pytest.mark.parametrize("case", list(PLAIN) + ["cached"])
def test_jax_two_device_checkpoint_restores_onto_two_ranks(ranks, case):
    out, refs, res = ranks
    jeng, leaves = refs[case][1], refs[case][2]
    cls = CachedTrainState if case == "cached" else TrainState
    for r in range(2):
        got = cls(**res[2][r][f"restore-{case}"]["state"])
        _equal_trees(got, state_to_numpy(
            shard_state(leaves, jeng.exchange, r, "cpu")))


def test_a_rank_reads_only_the_blocks_of_its_rows(ranks):
    """At the saved S a rank reads one block of each sharded leaf: its
    own file's of a port checkpoint (S = 2, 4), and the block at its rows
    of JAX's one file over 2 devices."""
    _, refs, res = ranks
    for S, name in ((2, "save-adam-f32"), (4, "save4"), (2, "save-cached")):
        for r in range(S):
            reads = res[S][r][name]["reads"]
            assert reads and {f for f, _ in reads} == {f"shards.p{r}.npz"}
            assert len(reads) == len(set(reads))
    n_sharded = 1 + len(refs["adam-f32"][2].table_slots)
    for r in range(2):
        reads = res[2][r]["restore-adam-f32"]["reads"]
        assert {f for f, _ in reads} == {"shards.p0.npz"}
        assert len(set(reads)) == len(reads) == n_sharded


def test_resize_two_ranks_to_one_device(ranks):
    """The port's and JAX's one-device restores of the 2-rank checkpoint
    (test_checkpoint_sched.py::test_checkpoint_cross_topology_resize)."""
    from herald_tpu.train.checkpoint import load_checkpoint as jax_load
    out, refs, _ = ranks
    jcfg, jeng, leaves = refs["adam-f32"][:3]
    one = Engine(dataclasses.replace(HeraldConfig.from_json(_port_cfg(jcfg)),
                                     comm_mode="local"),
                 table_rows=ROWS, device="cpu")
    st = ckpt.load_checkpoint(str(out / "port-adam-f32"), "cpu",
                              padded_rows=one.padded_rows)
    assert st.table.shape == (one.padded_rows, 8)
    np.testing.assert_array_equal(st.table.numpy()[:ROWS],
                                  jeng.exchange.to_logical(leaves.table))
    for k, v in leaves.table_slots.items():
        np.testing.assert_array_equal(st.table_slots[k].numpy()[:ROWS],
                                      jeng.exchange.to_logical(v))
    assert int(st.step) == STEPS
    _, e1 = _jax_engine(1)
    s1 = jax_load(str(out / "port-adam-f32"), e1.init_state(3))
    np.testing.assert_array_equal(np.asarray(s1.table)[:ROWS],
                                  jeng.exchange.to_logical(leaves.table))


def _joined(res, name):
    return join_states([TrainState(**r[name]["state"]) for r in res])


def test_resize_one_device_to_two_ranks(ranks):
    _, refs, res = ranks
    want = refs["from1"]
    got = _joined(res[2], "from1")
    spec = make_exchange(ROWS, 2, B * SPEC.num_sparse)
    np.testing.assert_array_equal(spec.to_logical(got.table),
                                  want.table[:ROWS])
    for k, v in want.table_slots.items():
        np.testing.assert_array_equal(spec.to_logical(got.table_slots[k]),
                                      v[:ROWS])
    _equal_trees(got.dense, want.dense)
    assert int(got.step) == STEPS


def test_resize_four_ranks_to_two(ranks):
    """test_checkpoint_sched.py::test_checkpoint_hybrid_resharding's
    restore across shard counts, from 4 port ranks' files."""
    _, refs, res = ranks
    jeng4, leaves4 = refs["from4"]
    got = _joined(res[2], "from4")
    spec = make_exchange(ROWS, 2, B * SPEC.num_sparse)
    assert got.table.shape == (spec.padded_rows, 8)
    np.testing.assert_array_equal(spec.to_logical(got.table),
                                  jeng4.exchange.to_logical(leaves4.table))
    for k, v in leaves4.table_slots.items():
        np.testing.assert_array_equal(spec.to_logical(got.table_slots[k]),
                                      jeng4.exchange.to_logical(v))
    _equal_trees(got.dense, leaves4.dense)
    _equal_trees(got.dense_slots, leaves4.dense_slots)


def test_cached_resize_raises(ranks):
    out, _, res = ranks
    for r in range(2):
        msg = res[2][r]["cached-resize"]
        assert msg and "cannot restore across topologies" in msg \
            and "sync_cache" in msg
    with pytest.raises(ValueError, match="sync_cache and checkpoint a "
                                         "plain TrainState"):
        ckpt.load_cached_checkpoint(str(out / "port-cached"), "cpu")


@pytest.mark.parametrize("case", list(PLAIN))
def test_steps_after_the_restore_match_jax(ranks, case):
    """JAX from its load of the port's checkpoint (f32) or from the state
    that both packages saved (bf16, which JAX's loader refuses)."""
    import jax
    from herald_tpu.train.checkpoint import load_checkpoint as jax_load
    out, refs, res = ranks
    jcfg, jeng, leaves, train, _ = refs[case]
    if PLAIN[case][1] == "f32":
        jst = jax_load(str(out / f"port-{case}"), jeng.init_state(1))
    else:
        jst = jax.tree.map(lambda like, a: jax.device_put(a, like.sharding),
                           jeng.init_state(1), leaves)
    jst, stats = jeng.train_epoch(jst, *train, steps=STEPS)
    want = _numpy_state(jst)
    bf16 = PLAIN[case][1] == "bf16"
    for r in range(2):
        got = res[2][r][f"restore-{case}"]
        assert got["overflow"] == np.asarray(stats["overflow"]).tolist()
        np.testing.assert_allclose(got["losses"], np.asarray(stats["loss"]),
                                   rtol=0, atol=1e-5 if bf16 else 1e-6)
    st = join_states([TrainState(**r[f"restore-{case}"]["trained"])
                      for r in res[2]])
    tab = TAB[PLAIN[case][1]]
    lg = jeng.exchange.to_logical
    np.testing.assert_allclose(_f32(lg(st.table)), _f32(lg(want.table)),
                               **tab)
    for k in want.table_slots:
        np.testing.assert_allclose(_f32(lg(st.table_slots[k])),
                                   _f32(lg(want.table_slots[k])), **tab)
    for k in want.dense:
        np.testing.assert_allclose(st.dense[k], want.dense[k], rtol=0,
                                   atol=1e-5)
    assert int(st.step) == int(want.step) == 2 * STEPS


def test_load_scorer_scores_a_two_rank_checkpoint(ranks):
    """One device serves the 2-rank checkpoint as the 2-rank engine
    scores the same state (JAX's checkpoint of it)."""
    from herald_tpu_torch.serve import load_scorer
    out, refs, res = ranks
    jcfg, _, _, _, (d, s, y) = refs["adam-f32"]
    scorer = load_scorer(str(out / "port-adam-f32"),
                         HeraldConfig.from_json(_port_cfg(jcfg)),
                         table_rows=ROWS, device="cpu")
    probs = scorer.score(d, s)
    for r in range(2):
        got = res[2][r]["restore-adam-f32"]
        np.testing.assert_allclose(probs[:2 * B], got["predict"], rtol=0,
                                   atol=1e-6)
        assert abs(auc_score(y, probs) - got["evaluate"]["auc"]) <= 1e-4


def test_a_rank_failing_before_its_shard_leaves_latest(tmp_path):
    with pytest.raises(Exception):
        run_ranks(_failing_rank, 2, tmp_path, tmp_path, timeout=120)
    root = tmp_path / "ck"
    assert (root / "LATEST").read_text() == "v2"
    assert not (root / "v4" / "shards.p1.npz").exists()
    st = ckpt.load_checkpoint(str(root), "cpu", padded_rows=1008)
    assert int(st.step) == 2


def test_a_node_that_cannot_see_replicated_npz_is_told_why(ranks, tmp_path):
    """Each rank writes its own shard file and rank 0 the replicated
    leaves: a node whose disk lacks rank 0's files is told that a
    multi-host checkpoint needs storage every process reads."""
    import shutil
    out, _, _ = ranks
    root = tmp_path / "local"
    shutil.copytree(out / "port-adam-f32", root)
    (root / (root / "LATEST").read_text() / "replicated.npz").unlink()
    with pytest.raises(FileNotFoundError, match="storage shared by every "
                                                "process"):
        ckpt.load_checkpoint(str(root), "cpu", padded_rows=1008)
