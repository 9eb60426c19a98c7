"""`export_state` and the launcher's `--export-onnx` over 2 gloo ranks on
the CPU, against herald_tpu's `export_state` of the same state on a
2-device mesh. The test process trains JAX's hybrid DeepFM (bf16 table)
and exports it, then spawns 2 ranks once (`tests/_ranks.py`), which:
- start from that state's blocks (`bridge.shard_state`) and export it:
  rank 0 receives rank 1's block and alone writes the file, whose table
  is bit for bit JAX's and whose scores agree with JAX's file within
  1e-6 and with the 2-rank engine's `predict` within rtol 1e-4, atol 1e-6
  (tests/test_onnx.py:114-115);
- refuse to export when the ranks span several nodes (`LOCAL_WORLD_SIZE`
  below the world size), with JAX's message;
- run the launcher with `--export-onnx` in the plain, assign-only and
  scheduled branches: rank 0's file, in JAX's `OnnxModel`, scores as the
  2-rank engine's `predict` of the run's final state.
"""

import os

import numpy as np
import pytest
import torch

from _ranks import run_ranks
from herald_tpu_torch import HeraldConfig
from herald_tpu_torch.bridge import shard_state
from herald_tpu_torch.data import synthetic_ctr_data
from herald_tpu_torch.models import get_model

ROWS, B = 2048, 16
SPEC = get_model("dfm_criteo").spec
COMMON = ["--model", "wdl_criteo", "--batch-size", "16",
          "--embedding-size", "8", "--rows", "3000", "--val-ratio", "0.2",
          "--scan-steps", "8", "--seed", "5", "--lr", "0.5", "--nepoch", "1",
          "--samples", "1600"]
RUNS = {"plain": [], "assign-only": ["--assign-only"],
        "scheduled": ["--scheduled", "--cache-limit-ratio", "0.3",
                      "--pinned-rows", "64"]}


def _predict(eng, state, d, s):
    """The engine's probabilities of every global batch of (d, s)."""
    gb = eng.cfg.batch_size * eng.num_shards
    return np.concatenate([eng.predict(state, d[i:i + gb],
                                       s[i:i + gb]).numpy()
                           for i in range(0, len(s), gb)])


def _onnx_rank(rank, S, init, out):
    torch.set_num_threads(1)
    import herald_tpu_torch.onnx as port_onnx
    from herald_tpu_torch.launch import cli
    from herald_tpu_torch.parallel import comm
    from herald_tpu_torch.train.engine import Engine, TrainState
    comm.setup("cpu", init_method=init, rank=rank, world_size=S)
    d, s = np.load(out / "d.npy"), np.load(out / "s.npy")
    eng = Engine(HeraldConfig.from_json((out / "cfg.json").read_text()),
                 table_rows=ROWS, device="cpu")
    state = TrainState(**torch.load(out / f"init.r{rank}.pt",
                                    weights_only=False))
    port_onnx.export_state(eng, state, str(out / "port.onnx"))
    probs = _predict(eng, state, d, s)
    if rank == 0:
        np.save(out / "port_probs.npy", probs)
    # ranks on several nodes: no rank holds the whole table
    os.environ["LOCAL_WORLD_SIZE"] = "1"
    try:
        port_onnx.export_state(eng, state, str(out / "refused.onnx"))
    except ValueError as e:
        (out / f"refused.r{rank}.txt").write_text(str(e))
    del os.environ["LOCAL_WORLD_SIZE"]
    # the launcher; the engine and state it exports are kept for predict
    real, seen = port_onnx.export_state, {}

    def record(eng, state, path, batch_size=None):
        seen.update(eng=eng, state=state)
        return real(eng, state, path, batch_size)
    port_onnx.export_state = record
    ids = np.load(out / "launch_s.npy")
    dx = np.load(out / "launch_d.npy")
    for name, argv in RUNS.items():
        cli.run_training(cli.build_parser().parse_args(
            COMMON + argv + ["--device", "cpu", "--comm", "hybrid",
                             "--export-onnx", str(out / f"{name}.onnx")]))
        probs = _predict(seen["eng"], seen["state"], dx, ids)
        if rank == 0:
            np.save(out / f"{name}_probs.npy", probs)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from herald_tpu import HeraldConfig as JaxConfig
    from herald_tpu.onnx import export_state as jax_export_state
    from herald_tpu.train.engine import Engine as JaxEngine
    out = tmp_path_factory.mktemp("onnx_hybrid")
    jcfg = JaxConfig(model="dfm_criteo", batch_size=B, embedding_dim=8,
                     comm_mode="hybrid", learning_rate=0.1,
                     table_dtype=jnp.bfloat16, a2a_capacity_factor=8.0)
    jeng = JaxEngine(jcfg, mesh=Mesh(np.array(jax.devices()[:2]), ("dp",)),
                     table_rows=ROWS)
    d, s, y = synthetic_ctr_data(SPEC, 2 * B * 8, seed=3, num_rows=ROWS)
    jst, _ = jeng.train_epoch(jeng.init_state(0), d, s, y)
    jax_export_state(jeng, jst, str(out / "jax.onnx"))
    leaves = jax.tree.map(np.array, jst)
    for r in range(2):
        torch.save(shard_state(leaves, jeng.exchange, r, "cpu")._asdict(),
                   out / f"init.r{r}.pt")
    (out / "cfg.json").write_text(
        HeraldConfig.from_json(jcfg.to_json()).to_json())
    np.save(out / "d.npy", d[:4 * B]), np.save(out / "s.npy", s[:4 * B])
    rs = np.random.RandomState(0)
    np.save(out / "launch_s.npy", rs.randint(0, 3000, (4 * B, 26)))
    np.save(out / "launch_d.npy", rs.randn(4 * B, 13).astype(np.float32))
    run_ranks(_onnx_rank, 2, out, out, timeout=240)
    return out


def _score(path, d, s, batch=B):
    from herald_tpu.onnx import OnnxModel as JaxOnnxModel
    om = JaxOnnxModel.load(str(path))
    return np.concatenate([
        om(sparse_ids=s[i:i + batch].astype(np.int64),
           dense_x=d[i:i + batch].astype(np.float32))[0]
        for i in range(0, len(s), batch)])


def test_rank_zeros_file_is_jaxs_export(exported):
    from herald_tpu.onnx import OnnxModel as JaxOnnxModel
    out = exported
    assert not (out / "refused.onnx").exists()
    mine, theirs = (JaxOnnxModel.load(str(out / f)).initializers
                    for f in ("port.onnx", "jax.onnx"))
    assert mine["embedding_table"].shape == (ROWS, 9)
    assert mine["embedding_table"].tobytes() == \
        theirs["embedding_table"].tobytes()
    d, s = np.load(out / "d.npy"), np.load(out / "s.npy")
    got, want = _score(out / "port.onnx", d, s), _score(out / "jax.onnx",
                                                        d, s)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.load(out / "port_probs.npy"),
                               rtol=1e-4, atol=1e-6)


def test_ranks_on_several_nodes_refuse_with_jaxs_message(exported):
    for r in range(2):
        msg = (exported / f"refused.r{r}.txt").read_text()
        assert msg.startswith("export_state needs the full table on this "
                              "process; in multi-process runs save a "
                              "checkpoint instead")


@pytest.mark.parametrize("name", sorted(RUNS))
def test_launcher_exports_over_two_ranks(exported, name):
    out = exported
    d, s = np.load(out / "launch_d.npy"), np.load(out / "launch_s.npy")
    probs = _score(out / f"{name}.onnx", d, s)     # per-rank batch of 16
    assert probs.shape == (4 * B,)
    np.testing.assert_allclose(probs, np.load(out / f"{name}_probs.npy"),
                               rtol=1e-4, atol=1e-6)
