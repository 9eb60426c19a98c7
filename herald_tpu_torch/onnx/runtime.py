"""Load and run exported .onnx files (the port's own copy of
`herald_tpu/onnx/runtime.py`).

`OnnxModel` is a pure-numpy interpreter of the op set that the exporters
of both packages emit; an unknown op raises with its name. It is the
serving side's reader of a file and the tests' independent oracle of the
exporter. `OnnxModel.load` maps the file (`proto.load_mapped`): an
initializer is a numpy view of the mapped bytes, so a table of many GB is
neither read nor copied, and a Gather reads only the rows it takes.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from herald_tpu_torch.onnx import proto

_NP_DT = {proto.DT_FLOAT: np.float32, proto.DT_INT64: np.int64,
          proto.DT_INT32: np.int32, proto.DT_BOOL: np.bool_,
          proto.DT_DOUBLE: np.float64}


def _tensor_to_np(t: dict) -> np.ndarray:
    dt = _NP_DT[t["data_type"]]
    dims = [int(d) for d in t.get("dims", [])]
    if "raw_data" in t:
        arr = np.frombuffer(t["raw_data"], dtype=dt)
    elif "float_data" in t:
        arr = np.asarray(t["float_data"], dtype=dt)
    elif "int64_data" in t:
        arr = np.asarray(t["int64_data"], dtype=dt)
    else:
        arr = np.zeros(0, dt)
    return arr.reshape(dims)


def _attrs(node: dict) -> Dict:
    out = {}
    for a in node.get("attribute", []):
        t = a.get("type")
        if t == proto.ATTR_INT:
            out[a["name"]] = int(a.get("i", 0))
        elif t == proto.ATTR_FLOAT:
            out[a["name"]] = float(a.get("f", 0.0))
        elif t == proto.ATTR_INTS:
            out[a["name"]] = [int(x) for x in a.get("ints", [])]
        elif t == proto.ATTR_TENSOR:
            out[a["name"]] = _tensor_to_np(a["t"])
        else:
            out[a["name"]] = a
    return out


class OnnxModel:
    """A parsed .onnx file plus a numpy executor for it."""

    def __init__(self, model_proto: dict, mapped=None):
        self.proto = model_proto
        # the mmap the initializers view (load), kept alive with them
        self._mapped = mapped
        g = model_proto["graph"]
        self.nodes: List[dict] = g.get("node", [])
        self.initializers = {t["name"]: _tensor_to_np(t)
                             for t in g.get("initializer", [])}
        self.input_names = [v["name"] for v in g.get("input", [])
                            if v["name"] not in self.initializers]
        self.output_names = [v["name"] for v in g.get("output", [])]

    @classmethod
    def load(cls, path: str) -> "OnnxModel":
        return cls(*proto.load_mapped(path))

    def __call__(self, **inputs) -> List[np.ndarray]:
        env: Dict[str, np.ndarray] = dict(self.initializers)
        for k in self.input_names:
            env[k] = np.asarray(inputs[k])
        for node in self.nodes:          # graphs are topologically sorted
            ins = [env[i] for i in node.get("input", [])]
            out = _run_op(node["op_type"], ins, _attrs(node))
            env[node["output"][0]] = out
        return [env[n] for n in self.output_names]


def _gather(data: np.ndarray, idx: np.ndarray, axis: int) -> np.ndarray:
    if axis == 0 and not data.flags.aligned:
        # a view of a mapped file at an offset its dtype does not divide:
        # np.take would first copy the whole array; take the rows' bytes
        rows = data.reshape(len(data), -1).view(np.uint8)
        return np.take(rows, idx, axis=0).view(data.dtype).reshape(
            idx.shape + data.shape[1:])
    return np.take(data, idx, axis=axis)


def _run_op(op: str, ins: List[np.ndarray], a: Dict) -> np.ndarray:
    if op == "Gather":
        return _gather(ins[0], ins[1].astype(np.int64), a.get("axis", 0))
    if op == "MatMul":
        return ins[0] @ ins[1]
    if op == "Add":
        return ins[0] + ins[1]
    if op == "Sub":
        return ins[0] - ins[1]
    if op == "Mul":
        return ins[0] * ins[1]
    if op == "Div":
        return ins[0] / ins[1]
    if op == "Neg":
        return -ins[0]
    if op == "Relu":
        return np.maximum(ins[0], 0)
    if op == "Max":
        return np.maximum(ins[0], ins[1])
    if op == "Min":
        return np.minimum(ins[0], ins[1])
    if op == "Exp":
        return np.exp(ins[0])
    if op == "Log":
        return np.log(ins[0])
    if op == "Tanh":
        return np.tanh(ins[0])
    if op == "Pow":
        return ins[0] ** ins[1]
    if op == "Sigmoid":
        x = ins[0]
        return np.where(x >= 0, 1.0 / (1.0 + np.exp(-np.abs(x))),
                        np.exp(-np.abs(x)) / (1.0 + np.exp(-np.abs(x))))
    if op == "Concat":
        return np.concatenate(ins, axis=a["axis"])
    if op == "Reshape":
        return ins[0].reshape([int(d) for d in ins[1]])
    if op == "ReduceSum":
        return np.sum(ins[0], axis=tuple(a["axes"]),
                      keepdims=bool(a.get("keepdims", 1)))
    if op == "Slice":
        starts, ends = ins[1], ins[2]
        axes = ins[3] if len(ins) > 3 else np.arange(len(starts))
        steps = ins[4] if len(ins) > 4 else np.ones(len(starts), np.int64)
        sl = [slice(None)] * ins[0].ndim
        for s, e, ax, st in zip(starts, ends, axes, steps):
            sl[int(ax)] = slice(int(s), int(e), int(st))
        return ins[0][tuple(sl)]
    if op == "Squeeze":
        return np.squeeze(ins[0], axis=tuple(a["axes"]))
    if op == "Expand":
        return np.broadcast_to(
            ins[0], np.broadcast_shapes(ins[0].shape,
                                        tuple(int(d) for d in ins[1])))
    if op == "Cast":
        return ins[0].astype(_NP_DT[a["to"]])
    if op == "Transpose":
        return np.transpose(ins[0], a["perm"])
    if op == "Identity":
        return ins[0]
    raise NotImplementedError(f"ONNX op {op!r} not implemented in "
                              f"herald_tpu_torch.onnx.runtime")

