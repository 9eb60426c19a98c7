"""Export trained models to standard `.onnx` files (port of
`herald_tpu/onnx/export.py`).

Where JAX walks the tower's jaxpr, the port traces the tower with
`torch.fx.experimental.proxy_tensor.make_fx`, the counterpart of
`jax.make_jaxpr`: a functional graph of aten ops, each translated into
ONNX nodes of the op set both packages' runtimes run (`runtime.py`). The
trace runs on CPU zeros with the dense params as CPU f32 tensors, so every
kernel wrapper takes its plain version (a kernel launched through ctypes
leaves no trace). Tensors the tower closes over become initializers.

Exported graph (as JAX's):
    sparse_ids:int64[B,F], dense_x:float[B,ND]
    emb = Gather(embedding_table, sparse_ids)
    logits = <the tower's aten graph as ONNX nodes>
    probs = Sigmoid(logits)
The embedding table is written as an f32 initializer, streamed to the
file in chunks (`proto.Payload`) from a table of any float dtype on any
device: a bf16 table on the card is copied and widened a chunk at a time
on the host. As in JAX the file is one protobuf with no external data, so
a table over 2 GiB makes a file that parsers bound by protobuf's 2 GiB
message limit refuse; both packages' `OnnxModel` read it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from herald_tpu_torch.onnx import proto

OPSET = 12
_DT = {np.dtype("float32"): proto.DT_FLOAT,
       np.dtype("int64"): proto.DT_INT64,
       np.dtype("int32"): proto.DT_INT32,
       np.dtype("bool"): proto.DT_BOOL,
       np.dtype("float64"): proto.DT_DOUBLE}
# bytes of f32 table rows widened and written at a time
CHUNK_BYTES = 64 << 20

# aten ops that are one ONNX node of the same inputs
_ELEMENTWISE = {
    "aten.mm.default": "MatMul",
    "aten.mul.Tensor": "Mul",
    "aten.relu.default": "Relu",
    "aten.clone.default": "Identity",
    "aten.alias.default": "Identity",
}


def _tensor(name: str, arr: np.ndarray) -> dict:
    arr = np.asarray(arr)
    if arr.dtype == np.dtype("float64"):
        arr = arr.astype(np.float32)
    if arr.dtype not in _DT:
        raise ValueError(f"unsupported initializer dtype {arr.dtype}")
    return {"name": name, "dims": list(arr.shape),
            "data_type": _DT[arr.dtype],
            "raw_data": arr.tobytes()}       # little-endian per spec


def _table_tensor(name: str, table) -> dict:
    """The f32 initializer of a [rows, W] table (a tensor of any float
    dtype on any device, or a numpy array), its bytes streamed to the file
    a chunk of rows at a time."""
    rows, width = (int(d) for d in table.shape)
    step = max(1, CHUNK_BYTES // (4 * max(width, 1)))

    def write_to(f):
        for lo in range(0, rows, step):
            part = table[lo:lo + step]
            if isinstance(part, torch.Tensor):
                # to the host in the table's dtype, widened there
                part = part.detach().cpu().float().numpy()
            f.write(memoryview(np.ascontiguousarray(part, np.float32)))

    return {"name": name, "dims": [rows, width],
            "data_type": proto.DT_FLOAT,
            "raw_data": proto.Payload(4 * rows * width, write_to)}


def _vinfo(name: str, dtype: int, shape) -> dict:
    return {"name": name, "type": {"tensor_type": {
        "elem_type": dtype,
        "shape": {"dim": [{"dim_value": int(d)} for d in shape]}}}}


class _Builder:
    def __init__(self):
        self.nodes: List[dict] = []
        self.inits: List[dict] = []
        self.counter = 0

    def fresh(self, hint: str = "t") -> str:
        self.counter += 1
        return f"{hint}_{self.counter}"

    def init_const(self, arr, hint="const") -> str:
        name = self.fresh(hint)
        self.inits.append(_tensor(name, np.asarray(arr)))
        return name

    def node(self, op: str, inputs: List[str], attrs: Optional[dict] = None,
             hint: Optional[str] = None) -> str:
        out = self.fresh(hint or op.lower())
        attributes = []
        for k, v in (attrs or {}).items():
            if isinstance(v, int):
                attributes.append({"name": k, "i": v,
                                   "type": proto.ATTR_INT})
            elif isinstance(v, float):
                attributes.append({"name": k, "f": v,
                                   "type": proto.ATTR_FLOAT})
            elif isinstance(v, (list, tuple)):
                attributes.append({"name": k, "ints": [int(x) for x in v],
                                   "type": proto.ATTR_INTS})
            else:
                raise ValueError(f"attr {k}={v!r}")
        self.nodes.append({"input": inputs, "output": [out],
                           "name": out, "op_type": op,
                           **({"attribute": attributes} if attributes
                              else {})})
        return out


def _i64(values) -> np.ndarray:
    return np.asarray(values, np.int64)


def _convert_graph(b: _Builder, gm: torch.fx.GraphModule,
                   inputs: List[str]) -> str:
    """Translate a make_fx graph's nodes; `inputs` are the ONNX names of
    its placeholders in order. Returns the ONNX name of its output."""
    env: Dict[torch.fx.Node, str] = {}
    placeholders = iter(inputs)

    def shape(n) -> tuple:
        return tuple(n.meta["val"].shape)

    for n in gm.graph.nodes:
        if n.op == "placeholder":
            env[n] = next(placeholders)
            continue
        if n.op == "get_attr":
            env[n] = b.init_const(
                getattr(gm, n.target).detach().cpu().numpy(), "param")
            continue
        if n.op == "output":         # the tower's logits
            return env[n.args[0]]
        if n.op != "call_function":
            raise NotImplementedError(f"fx node {n.op} {n.target}")
        p = str(n.target)
        dtype = n.meta["val"].dtype

        def read(a) -> str:
            if isinstance(a, torch.fx.Node):
                return env[a]
            # a Python scalar operand: a 0-d constant of the result's dtype
            return b.init_const(torch.tensor(a, dtype=dtype).numpy(), "lit")

        def axis(d, rank) -> int:
            return int(d) % rank

        args = n.args
        if p in _ELEMENTWISE:
            out = b.node(_ELEMENTWISE[p], [read(a) for a in args])
        elif p in ("aten.add.Tensor", "aten.sub.Tensor"):
            if n.kwargs.get("alpha", 1) != 1:
                raise NotImplementedError(f"{p} with alpha "
                                          f"{n.kwargs['alpha']}")
            out = b.node("Add" if p == "aten.add.Tensor" else "Sub",
                         [read(a) for a in args])
        elif p == "aten.cat.default":
            dim = args[1] if len(args) > 1 else n.kwargs.get("dim", 0)
            out = b.node("Concat", [read(a) for a in args[0]],
                         {"axis": axis(dim, len(shape(n)))})
        elif p == "aten.sum.dim_IntList":
            rank = len(shape(args[0]))
            keep = args[2] if len(args) > 2 else n.kwargs.get("keepdim",
                                                              False)
            out = b.node("ReduceSum", [read(args[0])],
                         {"axes": [axis(d, rank) for d in args[1]],
                          "keepdims": int(bool(keep))})
        elif p in ("aten.view.default", "aten._unsafe_view.default"):
            out = b.node("Reshape", [read(args[0]),
                                     b.init_const(_i64(shape(n)), "shape")])
        elif p == "aten.select.int":
            src = shape(args[0])
            d = axis(args[1], len(src))
            idx = b.init_const(_i64(int(args[2]) % src[d]), "index")
            out = b.node("Gather", [read(args[0]), idx], {"axis": d})
        elif p == "aten.slice.Tensor":
            src = shape(args[0])
            d = axis(args[1] if len(args) > 1 else 0, len(src))
            start, end, step = (list(args[2:5]) + [None] * 3)[:3]
            # torch's open end is INT64_MAX: clamp into the dimension
            start, end = (slice(start, end).indices(src[d])[:2])
            out = b.node("Slice", [
                read(args[0]),
                b.init_const(_i64([start]), "starts"),
                b.init_const(_i64([end]), "ends"),
                b.init_const(_i64([d]), "axes"),
                b.init_const(_i64([step or 1]), "steps")])
        else:
            raise NotImplementedError(
                f"aten op {p!r} has no ONNX mapping; extend "
                f"herald_tpu_torch/onnx/export.py (args: {args})")
        env[n] = out
    raise ValueError("fx graph without an output node")


def _host_f32(x) -> torch.Tensor:
    """A param (a tensor on any device, or a host array) as a CPU f32
    tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(x, np.float32))


def export_inference(model, dense_params, table_logical, path: str,
                     batch_size: int = 256, doc: str = "") -> None:
    """Write `<path>` as a standard .onnx inference graph for `model`.

    dense_params: the trained tower params (tensors on any device, or host
    arrays); table_logical: the embedding table in LOGICAL row order
    [rows, W], a tensor of any float dtype on any device or a numpy array
    (written as f32, a chunk at a time)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    if getattr(model, "bags", None) is not None:
        raise NotImplementedError(
            f"export_inference: model {model.name!r} reads multi-hot bags, "
            f"which the ONNX graph does not pool yet (ROADMAP item 49)")
    B = batch_size
    F = model.spec.num_sparse
    ND = max(model.spec.num_dense, 0)
    W = int(table_logical.shape[1])
    b = _Builder()

    table_name = "embedding_table"
    b.inits.append(_table_tensor(table_name, table_logical))
    emb_name = b.node("Gather", [table_name, "sparse_ids"],
                      {"axis": 0}, hint="emb")

    params = {k: _host_f32(v) for k, v in dense_params.items()}
    with torch.no_grad():
        gm = make_fx(lambda e, d: model.apply(params, e, d))(
            torch.zeros((B, F, W)), torch.zeros((B, ND)))
    logits = _convert_graph(b, gm, [emb_name, "dense_x"])
    b.nodes.append({"input": [logits], "output": ["probs"],
                    "name": "probs", "op_type": "Sigmoid"})

    graph = {
        "name": f"herald_tpu_{model.name}",
        "node": b.nodes,
        "initializer": b.inits,
        "input": [_vinfo("sparse_ids", proto.DT_INT64, (B, F)),
                  _vinfo("dense_x", proto.DT_FLOAT, (B, ND))],
        "output": [_vinfo("probs", proto.DT_FLOAT, (B,))],
        "doc_string": doc,
    }
    m = {"ir_version": 8,
         "producer_name": "herald_tpu",
         "producer_version": "1.0",
         "model_version": 1,
         "graph": graph,
         "opset_import": [{"domain": "", "version": OPSET}]}
    with open(path, "wb") as f:
        proto.write(f, "ModelProto", m)


def _logical_table(engine, block: torch.Tensor) -> Optional[torch.Tensor]:
    """The logical [num_rows, W] table on rank 0's host, from every rank's
    block, each received in turn over a gloo group of the engine's ranks;
    None on the other ranks. Rank 0 alone holds the whole table."""
    comm, spec = engine.comm, engine.exchange
    host = comm.host_group()
    block = block.detach().cpu()
    if comm.rank != 0:
        host.send(block.view(torch.uint8), 0)
        return None
    n = spec.rows_per_shard
    phys = block.new_empty((comm.size * n,) + tuple(block.shape[1:]))
    phys[:n] = block
    for r in range(1, comm.size):
        host.recv_(phys[r * n:(r + 1) * n].view(torch.uint8), r)
    # numpy has no bf16: a 2-byte table crosses as its int16 bits
    two = phys.element_size() == 2
    arr = spec.to_logical((phys.view(torch.int16) if two else phys).numpy())
    out = torch.from_numpy(arr)
    return out.view(phys.dtype) if two else out


def export_state(engine, state, path: str,
                 batch_size: Optional[int] = None) -> None:
    """Export an engine's trained state (`Engine`, or `CachedEngine` after
    `sync_cache`). Over S ranks every rank calls it: rank 0 receives each
    rank's block and alone writes the file, and every rank returns once
    it is written. The file bakes in `batch_size`, by default the
    per-rank `cfg.batch_size`. A tensor-parallel state's tower is gathered
    over the mp group first (JAX `onnx/export.py:287-303`)."""
    if hasattr(state, "hot_table") and not hasattr(state, "cache"):
        raise ValueError("export_state does not support FAE states "
                         "(hot/cold split state); train the plain or "
                         "scheduled mode to export")
    if getattr(engine, "_unsynced", False):
        raise ValueError("export_state needs a synced cached state: the "
                         "owner table is missing unflushed cache deltas; "
                         "call sync_cache(state, planner) first")
    S = engine.num_shards
    if S > 1 and int(os.environ.get("LOCAL_WORLD_SIZE", S)) < S:
        # ranks on several nodes: no process can hold the whole table
        raise ValueError(
            "export_state needs the full table on this process; in "
            "multi-process runs save a checkpoint instead and export "
            "from a single-process load (load_checkpoint -> "
            "export_state)")
    dense = engine.global_dense(state.dense)
    table = (_logical_table(engine, state.table) if S > 1
             else state.table[:engine.num_rows])
    if table is not None:
        export_inference(engine.model, dense, table, path,
                         batch_size=batch_size or engine.cfg.batch_size)
    if S > 1:
        engine.comm.barrier()
