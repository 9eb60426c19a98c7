"""The port's ONNX export and import (`herald_tpu_torch/onnx/`) against
`herald_tpu/onnx/` on the CPU.

- The codec: `encode` gives JAX's bytes on the codec test of
  tests/test_onnx.py, the streaming writer gives `encode`'s bytes, and the
  mapped reader gives views of the file.
- Every model of JAX's registry (the port's own multi-hot model refuses
  export, `tests/test_torch_dlrm.py`): JAX's `init_dense` params go through numpy
  into the port, the port exports, and the file runs in both packages'
  `OnnxModel` within 1e-5 of `sigmoid(model.apply)` from JAX (the
  tolerance of tests/test_onnx.py); JAX's own file of the same params runs
  in the port's runtime with JAX's runtime's bits; every op the port emits
  is one JAX's runtime runs.
- `export_state` on a trained plain `Engine` and on a `CachedEngine` after
  `sync_cache`; an unsynced or FAE state raises.
- The launcher's `--export-onnx` in the plain, assign-only and scheduled
  branches at one rank: JAX's `OnnxModel` reproduces the port's `predict`
  of the final state within rtol 1e-4, atol 1e-6 (tests/test_onnx.py:
  114-115); an early-stopped scheduled run exits with JAX's message.
"""

import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import herald_tpu_torch.onnx as port_onnx
from herald_tpu.models import available_models as jax_available_models
from herald_tpu.models import get_model as jax_get_model
from herald_tpu.onnx import OnnxModel as JaxOnnxModel
from herald_tpu.onnx import export_inference as jax_export_inference
from herald_tpu.onnx import proto as jax_proto
from herald_tpu.onnx import runtime as jax_runtime
from herald_tpu_torch import HeraldConfig
from herald_tpu_torch.data import synthetic_ctr_data
from herald_tpu_torch.launch import cli
from herald_tpu_torch.models import get_model
from herald_tpu_torch.onnx import (OnnxModel, export, export_inference,
                                   export_state, proto, runtime)
from herald_tpu_torch.train.cached import CachedEngine
from herald_tpu_torch.train.engine import Engine

# the op types JAX's runtime runs
JAX_OPS = set(re.findall(r'op == "(\w+)"',
                         inspect.getsource(jax_runtime._run_op)))


def _codec_model():
    """The message of tests/test_onnx.py::test_proto_codec_roundtrip."""
    return {
        "ir_version": 8,
        "producer_name": "herald_tpu",
        "model_version": 1,
        "opset_import": [{"domain": "", "version": 12}],
        "graph": {
            "name": "g",
            "node": [{"input": ["x", "W"], "output": ["y"], "name": "n0",
                      "op_type": "MatMul"},
                     {"input": ["y"], "output": ["z"], "name": "n1",
                      "op_type": "ReduceSum",
                      "attribute": [{"name": "axes", "ints": [0, 1],
                                     "type": proto.ATTR_INTS},
                                    {"name": "keepdims", "i": 0,
                                     "type": proto.ATTR_INT}]}],
            "initializer": [{"name": "W", "dims": [2, 3],
                             "data_type": proto.DT_FLOAT,
                             "raw_data": np.arange(6, dtype=np.float32)
                             .tobytes()}],
            "input": [{"name": "x", "type": {"tensor_type": {
                "elem_type": proto.DT_FLOAT,
                "shape": {"dim": [{"dim_value": 4}, {"dim_value": 2}]}}}}],
            "output": [{"name": "z", "type": {"tensor_type": {
                "elem_type": proto.DT_FLOAT,
                "shape": {"dim": []}}}}],
        },
    }


def test_codec_matches_jax_bytes():
    m = _codec_model()
    data = proto.encode("ModelProto", m)
    assert data == jax_proto.encode("ModelProto", m)
    assert proto.SCHEMAS == jax_proto.SCHEMAS
    back = proto.decode("ModelProto", data)
    assert back == jax_proto.decode("ModelProto", data)
    assert back["graph"]["node"][1]["attribute"][0]["ints"] == [0, 1]
    # negative varints survive (int64 twos-complement, 10-byte form)
    neg = {"name": "i", "i": -3, "type": proto.ATTR_INT}
    assert proto.encode("AttributeProto", neg) == \
        jax_proto.encode("AttributeProto", neg)
    assert proto.decode("AttributeProto",
                        proto.encode("AttributeProto", neg))["i"] == -3


def test_streaming_writer_gives_encodes_bytes_and_load_maps(tmp_path):
    m = _codec_model()
    raw = m["graph"]["initializer"][0]["raw_data"]
    chunks = []

    def write_to(f):
        for lo in range(0, len(raw), 8):        # three writes
            chunks.append(lo)
            f.write(raw[lo:lo + 8])

    streamed = _codec_model()
    streamed["graph"]["initializer"][0]["raw_data"] = proto.Payload(
        len(raw), write_to)
    path = tmp_path / "m.onnx"
    with open(path, "wb") as f:
        n = proto.write(f, "ModelProto", streamed)
    assert chunks == [0, 8, 16]
    assert path.read_bytes() == proto.encode("ModelProto", m)
    assert n == path.stat().st_size
    got, mm = proto.load_mapped(str(path))
    init = got["graph"]["initializer"][0]
    assert isinstance(init["raw_data"], memoryview)
    assert bytes(init["raw_data"]) == raw
    assert got["graph"]["node"] == \
        jax_proto.decode("ModelProto", path.read_bytes())["graph"]["node"]
    # a payload that writes another length than it declared raises
    bad = _codec_model()
    bad["graph"]["initializer"][0]["raw_data"] = proto.Payload(
        len(raw) + 4, write_to)
    with open(tmp_path / "bad.onnx", "wb") as f, \
            pytest.raises(ValueError, match="declared"):
        proto.write(f, "ModelProto", bad)
    del init, got
    mm.close()


def test_runtime_runs_jax_runtimes_op_set():
    mine = set(re.findall(r'op == "(\w+)"',
                          inspect.getsource(runtime._run_op)))
    assert mine == JAX_OPS and len(mine) == 24


def test_gather_from_an_unaligned_table_takes_its_rows():
    """A mapped table at an offset its dtype does not divide: the rows of
    np.take, from their bytes (np.take would first copy the whole
    array)."""
    buf = bytearray(4 * 1000 * 6 + 2)
    table = np.frombuffer(memoryview(buf)[2:], np.float32).reshape(1000, 6)
    np.copyto(np.frombuffer(memoryview(buf)[2:], np.float32),
              np.arange(6000, dtype=np.float32))
    assert not table.flags.aligned
    ids = np.random.RandomState(0).randint(0, 1000, (4, 3))
    for idx in (ids, np.int64(7)):
        got = runtime._run_op("Gather", [table, np.asarray(idx)], {"axis": 0})
        want = np.take(table.copy(), idx, axis=0)
        assert got.dtype == np.float32 and got.flags.aligned
        np.testing.assert_array_equal(got, want)


def _ops(path) -> set:
    g = jax_proto.decode("ModelProto", open(path, "rb").read())["graph"]
    return {n["op_type"] for n in g["node"]}


@pytest.mark.parametrize("name", jax_available_models())
def test_every_model_exports_and_matches_jax(name, tmp_path):
    """JAX's init params through numpy into the port's exporter: the file
    runs in both runtimes within 1e-5 of JAX's forward; JAX's file of the
    same params runs in the port's runtime with JAX's runtime's bits."""
    rows, batch, D = 256, 8, 8
    jm = jax_get_model(name)
    jp = {k: np.asarray(v)
          for k, v in jm.init_dense(jax.random.PRNGKey(0), D).items()}
    table = 0.05 * np.random.RandomState(0).randn(
        rows, jm.emb_width(D)).astype(np.float32)
    mine, theirs = str(tmp_path / "port.onnx"), str(tmp_path / "jax.onnx")
    export_inference(get_model(name), jp, table, mine, batch_size=batch)
    jax_export_inference(jm, jp, table, theirs, batch_size=batch)
    rs = np.random.RandomState(1)
    ids = rs.randint(0, rows, (batch, jm.spec.num_sparse)).astype(np.int64)
    dx = rs.randn(batch, max(jm.spec.num_dense, 0)).astype(np.float32)
    ref = np.asarray(jax.nn.sigmoid(jm.apply(
        jp, jnp.asarray(table[ids]), jnp.asarray(dx))))
    for model in (OnnxModel.load(mine), JaxOnnxModel.load(mine)):
        (probs,) = model(sparse_ids=ids, dense_x=dx)
        assert probs.shape == (batch,) and probs.dtype == np.float32
        assert np.abs(probs - ref).max() < 1e-5, name
    (a,) = OnnxModel.load(theirs)(sparse_ids=ids, dense_x=dx)
    (b,) = JaxOnnxModel.load(theirs)(sparse_ids=ids, dense_x=dx)
    assert a.tobytes() == b.tobytes()
    assert _ops(mine) <= JAX_OPS
    g = jax_proto.decode("ModelProto", open(mine, "rb").read())
    assert (g["ir_version"], g["producer_name"],
            g["opset_import"][0]["version"]) == (8, "herald_tpu",
                                                 export.OPSET)
    assert g["graph"]["initializer"][0]["name"] == "embedding_table"
    assert [v["name"] for v in g["graph"]["output"]] == ["probs"]


def test_table_streams_in_chunks_from_bf16(tmp_path, monkeypatch):
    """A bf16 table widened a chunk at a time gives the bytes of its f32
    copy written whole."""
    model = get_model("wdl_criteo")
    params = model.init_dense(torch.Generator().manual_seed(0), 8)
    table = torch.randn(1000, 8, generator=torch.Generator().manual_seed(1)
                        ).bfloat16()
    export_inference(model, params, table.float().numpy(),
                     str(tmp_path / "whole.onnx"), batch_size=4)
    monkeypatch.setattr(export, "CHUNK_BYTES", 4 * 8 * 300)  # 4 chunks
    export_inference(model, params, table, str(tmp_path / "chunks.onnx"),
                     batch_size=4)
    assert (tmp_path / "whole.onnx").read_bytes() == \
        (tmp_path / "chunks.onnx").read_bytes()
    om = OnnxModel.load(str(tmp_path / "chunks.onnx"))
    assert torch.equal(torch.from_numpy(
        om.initializers["embedding_table"].copy()), table.float())


def test_unmapped_aten_op_raises(tmp_path):
    base = get_model("wdl_criteo")

    class Softmaxed:
        name, spec = "softmaxed", base.spec

        @staticmethod
        def apply(params, emb, dense):
            return torch.softmax(base.apply(params, emb, dense), 0)

    with pytest.raises(NotImplementedError, match="aten._softmax"):
        export_inference(Softmaxed, base.init_dense(
            torch.Generator().manual_seed(0), 4), np.zeros((10, 4),
                                                           np.float32),
            str(tmp_path / "m.onnx"), batch_size=2)


ROWS, B = 2048, 16


def _predict(eng, state, dense, sparse, batch):
    """The engine's probabilities over whole batches."""
    return np.concatenate([
        eng.predict(state, dense[i:i + batch], sparse[i:i + batch]).numpy()
        for i in range(0, len(sparse), batch)])


def _score(path, dense, sparse, batch):
    """Both runtimes' probabilities of the file over whole batches."""
    out = []
    for cls in (OnnxModel, JaxOnnxModel):
        om = cls.load(path)
        out.append(np.concatenate([
            om(sparse_ids=sparse[i:i + batch].astype(np.int64),
               dense_x=dense[i:i + batch].astype(np.float32))[0]
            for i in range(0, len(sparse), batch)]))
    return out


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_export_state_of_a_trained_engine(tmp_path, bf16):
    cfg = HeraldConfig(model="dfm_criteo", batch_size=B, embedding_dim=8,
                       learning_rate=0.1,
                       table_dtype=torch.bfloat16 if bf16 else torch.float32)
    eng = Engine(cfg, table_rows=ROWS, device="cpu")
    dense, sparse, labels = synthetic_ctr_data(eng.model.spec, B * 8,
                                               seed=3, num_rows=ROWS)
    state, _ = eng.train_epoch(eng.init_state(0), dense, sparse, labels)
    path = str(tmp_path / "m.onnx")
    export_state(eng, state, path)
    om = OnnxModel.load(path)
    assert torch.equal(torch.from_numpy(
        om.initializers["embedding_table"].copy()),
        state.table[:ROWS].float())
    ref = _predict(eng, state, dense[:2 * B], sparse[:2 * B], B)
    for probs in _score(path, dense[:2 * B], sparse[:2 * B], B):
        np.testing.assert_allclose(probs, ref, rtol=1e-4, atol=1e-6)


def test_export_state_of_a_cached_engine_needs_sync(tmp_path):
    cfg = HeraldConfig(model="wdl_criteo", batch_size=B, embedding_dim=8,
                       learning_rate=0.5, use_cache=True,
                       use_scheduler=True, cache_limit_ratio=0.3,
                       pinned_rows=32)
    eng = CachedEngine(cfg, table_rows=ROWS, device="cpu")
    d, s, y = synthetic_ctr_data(eng.model.spec, B * 8, seed=6,
                                 num_rows=ROWS)
    planner = eng.make_planner(s, epochs=1, n_threads=1)
    st, _ = eng.train_epoch_cached(eng.init_cached_state(0), planner, d, s,
                                   y, steps=8)
    path = str(tmp_path / "m.onnx")
    with pytest.raises(ValueError, match="sync_cache"):
        export_state(eng, st, path)
    st = eng.sync_cache(st, planner)
    export_state(eng, st, path, batch_size=2 * B)
    ref = _predict(eng, st, d[:2 * B], s[:2 * B], B)
    for probs in _score(path, d[:2 * B], s[:2 * B], 2 * B):
        np.testing.assert_allclose(probs, ref, rtol=1e-4, atol=1e-6)


def test_export_state_refuses_an_fae_state(tmp_path):
    from herald_tpu_torch.train.fae import FaeEngine
    cfg = HeraldConfig(model="wdl_criteo", batch_size=B, embedding_dim=8)
    eng = FaeEngine(cfg, table_rows=ROWS, hot_rate=0.1, device="cpu")
    with pytest.raises(ValueError, match="FAE"):
        export_state(eng, eng.init_fae_state(0), str(tmp_path / "m.onnx"))


# ----------------------------------------------------------------------
# the launcher's --export-onnx (tests/test_cli.py:178-196)
# ----------------------------------------------------------------------

COMMON = ["--model", "wdl_criteo", "--batch-size", "16",
          "--embedding-size", "8", "--samples", "1600", "--rows", "3000",
          "--val-ratio", "0.2", "--scan-steps", "8", "--seed", "5",
          "--lr", "0.5", "--nepoch", "1", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # small launches: one intra-op thread, so that parallel test workers
    # do not starve them (tests/test_torch_launch.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recording(monkeypatch):
    """Record the engine and state the launcher exports."""
    seen = {}
    real = port_onnx.export_state

    def record(eng, state, path, batch_size=None):
        seen.update(eng=eng, state=state, path=path)
        return real(eng, state, path, batch_size)
    monkeypatch.setattr(port_onnx, "export_state", record)
    return seen


@pytest.mark.parametrize("argv", [
    [], ["--assign-only"],
    ["--scheduled", "--cache-limit-ratio", "0.3", "--pinned-rows", "64"]],
    ids=["plain", "assign-only", "scheduled"])
def test_launcher_exports_onnx(tmp_path, monkeypatch, capsys, argv):
    seen = _recording(monkeypatch)
    path = str(tmp_path / "model.onnx")
    report = cli.run_training(cli.build_parser().parse_args(
        COMMON + argv + ["--export-onnx", path]))
    assert f"exported ONNX model to {path}" in capsys.readouterr().out
    assert seen["path"] == path and report["val_auc"] is not None
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 3000, (2 * B, 26)).astype(np.int64)
    dx = rs.randn(2 * B, 13).astype(np.float32)
    # the artifact bakes the configured (per-rank) batch size
    ref = _predict(seen["eng"], seen["state"], dx, ids, B)
    for probs in _score(path, dx, ids, B):
        assert probs.shape == (2 * B,)
        np.testing.assert_allclose(probs, ref, rtol=1e-4, atol=1e-6)


def test_early_stopped_scheduled_run_refuses_to_export(tmp_path):
    with pytest.raises(SystemExit, match="needs a fully-synced state"):
        cli.run_training(cli.build_parser().parse_args(
            COMMON + ["--scheduled", "--cache-limit-ratio", "0.3",
                      "--max-steps", "20", "--export-onnx",
                      str(tmp_path / "m.onnx")]))
    assert not (tmp_path / "m.onnx").exists()
