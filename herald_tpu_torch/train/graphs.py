"""CUDA graphs over the engines' steps: the port's counterpart of JAX's
compiled executor (`herald_tpu/train/engine.py` `_build_steps`, the
scanned `_epoch_body` and `_eval_scan_body`; `train/cached.py`'s chunk
programs; `train/fae.py`'s jitted step).

JAX compiles a step once and runs it as one device program. A step body
of the port is plain PyTorch that launches each of its ops from Python.
On the card, `StepGraphs` captures a body into a `torch.cuda.CUDAGraph`
and replays it: a step then costs the host one input copy, one replay and
one output copy, and waits for the card nowhere.

- Inputs: a step's inputs travel packed in one uint8 buffer (`pack`,
  `Layout`), on the card or in pinned host memory. Each graph owns a
  static buffer of that layout, and a step copies the packed buffer into
  it in one copy, or tensors already on the card into its views, one
  copy each.
- State: the state's own tensors are the graph's state. A body returns a
  new state; inside the capture every tensor of it that is not the old
  one is copied back into the tensor it replaces (one multi-tensor copy
  per element size), so after a replay the state handed in holds the new
  values. JAX donates the state to its step: in both packages the state
  handed in is consumed.
- Output: a body's one result (a loss, probabilities) is copied out of
  the graph's buffer before the next replay.
- Cache: one graph per step name (with its variant), input layout, and
  identity of the state's tensors and of any other tensor the body reads
  by address (`reads`). A graph keeps weak references to those tensors
  only; a graph whose tensors died is dropped at the next capture.
- Warm-up: the first step of each name and layout runs uncaptured, on the
  capture stream, and writes its state back as a replay does. It is a
  real step of the caller's, and it builds, loads and initializes what
  the body needs (the kernels' libraries, cuBLAS) before any capture of
  it.
- Launch counters: a replay launches the captured kernels without running
  their wrappers, so each graph takes back the launches its capture
  counted (a capture launches nothing) and adds them again on every
  replay.
- Memory: every graph of one `StepGraphs` allocates from one pool (a new
  one once every graph of the last has been dropped).
- No fallback: a failed capture or replay raises.
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from herald_tpu_torch.ops.kernels import KERNELS

_ALIGN = 16
# the dtypes a packed buffer carries
TORCH_DTYPES = {np.dtype(np.int16): torch.int16,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.float32): torch.float32}
# same-size integer views: a write-back copies bits, one kernel per size
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


class Field(NamedTuple):
    name: str
    dtype: torch.dtype
    shape: Tuple[int, ...]
    offset: int
    nbytes: int


class Layout(NamedTuple):
    """Where each input of one step lies in its packed buffer."""
    fields: Tuple[Field, ...]
    nbytes: int


def layout_of(specs: Sequence[Tuple[str, torch.dtype, Sequence[int]]]
              ) -> Layout:
    """The layout of (name, dtype, shape) inputs, each at a 16-byte
    aligned offset."""
    fields, off = [], 0
    for name, dtype, shape in specs:
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        fields.append(Field(name, dtype, tuple(int(s) for s in shape), off,
                            n))
        off += -(-n // _ALIGN) * _ALIGN
    return Layout(tuple(fields), max(off, _ALIGN))


def unpack(buf: torch.Tensor, layout: Layout) -> Dict[str, torch.Tensor]:
    """{name: view} of a packed uint8 buffer of one step."""
    return {f.name: buf[f.offset:f.offset + f.nbytes].view(f.dtype)
            .view(f.shape) for f in layout.fields}


def pack(arrays: Dict[str, np.ndarray], steps: Optional[int] = None,
         pin: bool = False) -> Tuple[torch.Tensor, Layout]:
    """Host arrays -> (uint8 host tensor, layout of one step). With
    `steps`, each array is [steps, ...] and the buffer [steps, nbytes],
    one step a row; pinned when `pin`, for a copy that does not wait."""
    arrays = {k: np.asarray(a) for k, a in arrays.items()}
    layout = layout_of((k, TORCH_DTYPES[a.dtype],
                        a.shape[1:] if steps else a.shape)
                       for k, a in arrays.items())
    rows = steps or 1
    buf = torch.empty((rows, layout.nbytes), dtype=torch.uint8,
                      pin_memory=pin)
    view = buf.numpy()
    ends = [f.offset for f in layout.fields[1:]] + [layout.nbytes]
    for f, a, end in zip(layout.fields, arrays.values(), ends):
        view[:, f.offset:f.offset + f.nbytes] = np.ascontiguousarray(
            a).reshape(rows, -1).view(np.uint8)
        # the alignment padding too: equal inputs pack to equal bytes
        view[:, f.offset + f.nbytes:end] = 0
    return (buf if steps else buf[0]), layout


class PackedSteps(NamedTuple):
    """The inputs of `steps` steps in one uint8 buffer `packed` [steps,
    nbytes], one step a row, as `layout` places them (`pack`): a chunk
    staged ahead of the step that reads it (`data/prefetch.py`)."""
    packed: torch.Tensor
    layout: Layout

    @property
    def steps(self) -> int:
        return int(self.packed.shape[0])

    def tensors(self) -> Dict[str, torch.Tensor]:
        """{name: [steps, ...] view} of every input."""
        return {f.name: self.packed[:, f.offset:f.offset + f.nbytes]
                .view(f.dtype).view(self.steps, *f.shape)
                for f in self.layout.fields}


def pack_tensors(tensors: Dict[str, torch.Tensor], steps: int
                 ) -> Tuple[torch.Tensor, Layout]:
    """Tensors [steps, ...] on one device -> (uint8 [steps, nbytes] on that
    device, layout of one step): one copy per tensor."""
    layout = layout_of((k, t.dtype, t.shape[1:]) for k, t in tensors.items())
    dev = next(iter(tensors.values())).device
    buf = torch.empty((steps, layout.nbytes), dtype=torch.uint8, device=dev)
    for f, t in zip(layout.fields, tensors.values()):
        buf[:, f.offset:f.offset + f.nbytes].view(f.dtype).view(
            steps, *f.shape).copy_(t)
    return buf, layout


def leaves(state) -> Dict[tuple, torch.Tensor]:
    """{path: tensor} of a state: NamedTuples, tuples and dicts walked."""
    out: Dict[tuple, torch.Tensor] = {}

    def walk(path, x):
        if isinstance(x, torch.Tensor):
            out[path] = x
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(path + (k,), v)
        elif isinstance(x, tuple):
            for i, v in enumerate(x):
                walk(path + (i,), v)

    walk((), state)
    return out


def write_back(old: Dict[tuple, torch.Tensor],
               new: Dict[tuple, torch.Tensor]) -> None:
    """Copy every new tensor that is not the old one into the old one,
    bit for bit, one multi-tensor copy per element size."""
    if old.keys() != new.keys():
        raise ValueError(f"a step changed its state's structure: "
                         f"{sorted(map(str, old))} -> "
                         f"{sorted(map(str, new))}")
    groups: Dict[int, Tuple[list, list]] = {}
    for path, a in old.items():
        b = new[path]
        if b is a:
            continue
        if b.shape != a.shape or b.dtype != a.dtype:
            raise ValueError(f"state leaf {path}: {a.dtype}{tuple(a.shape)}"
                             f" became {b.dtype}{tuple(b.shape)}")
        dst, src = groups.setdefault(a.element_size(), ([], []))
        dst.append(a.view(_BITS[a.element_size()]))
        src.append(b.view(_BITS[a.element_size()]))
    for dst, src in groups.values():
        torch._foreach_copy_(dst, src)


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


class _Graph:
    def __init__(self, graph, static, inputs, out, counts, refs):
        self.graph, self.static, self.inputs = graph, static, inputs
        self.out, self.counts, self.refs = out, counts, refs

    def alive(self) -> bool:
        return all(r() is not None for r in self.refs)


def feed_inputs(feed, device: torch.device) -> Dict[str, torch.Tensor]:
    """A feed's inputs as tensors on `device` (a host buffer is copied
    there without waiting)."""
    if isinstance(feed, dict):
        return feed
    buf, layout = feed
    return unpack(buf.to(device, non_blocking=True), layout)


class StepGraphs:
    """Captured steps of one engine on one card."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.captures = 0
        self._graphs: Dict[tuple, _Graph] = {}
        self._warm = set()
        # the serving front end scores from several threads
        self._lock = threading.Lock()

    def run(self, name, body: Callable, state, feed,
            out: Optional[torch.Tensor] = None,
            reads: Sequence[torch.Tensor] = ()):
        """One step of body(state, {name: input}) -> (new state, result):
        (state, result). `feed` is (a packed buffer of one step on the card
        or pinned on the host, its Layout) or {name: tensor on the card};
        `reads` are the tensors beside the state that the body reads by
        address. The result is copied into `out` when given, else into a
        new tensor."""
        with self._lock:
            layout = (feed[1] if isinstance(feed, tuple) else layout_of(
                (k, t.dtype, t.shape) for k, t in feed.items()))
            sig = (name, layout)
            if sig not in self._warm:
                return self._warm_up(sig, body, state, feed, out)
            state_leaves = leaves(state)
            key = (sig, tuple((p, id(t)) for p, t in state_leaves.items()),
                   tuple(id(t) for t in reads))
            g = self._graphs.get(key)
            if g is None or not g.alive():
                g = self._capture(key, body, state, state_leaves, layout,
                                  reads)
            if isinstance(feed, tuple):
                g.static.copy_(feed[0], non_blocking=True)
            else:
                for k, t in feed.items():
                    g.inputs[k].copy_(t)
            g.graph.replay()
            for k, n in g.counts.items():
                KERNELS[k].launches += n
            res = g.out.clone() if out is None else out.copy_(g.out)
            return state, res

    def _warm_up(self, sig, body, state, feed, out):
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            new_state, res = body(state, feed_inputs(feed, self.device))
            # into the state's own tensors, as a replay writes: the state
            # keeps its identity, and its graphs stay valid
            write_back(leaves(state), leaves(new_state))
            if out is not None:
                res = out.copy_(res)
        cur.wait_stream(self.stream)
        self._warm.add(sig)
        return state, res

    def _capture(self, key, body, state, state_leaves, layout, reads):
        self._graphs = {k: g for k, g in self._graphs.items() if g.alive()}
        if not self._graphs:
            # the pool is released with its last graph: take a new one
            self.pool = torch.cuda.graph_pool_handle()
        static = torch.empty(layout.nbytes, dtype=torch.uint8,
                             device=self.device)
        inputs = unpack(static, layout)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        try:
            with torch.cuda.stream(self.stream):
                # cuBLAS makes each thread's handle at its first call,
                # which a capture may not do: make this thread's first (a
                # server scores in a new thread for every request)
                torch.cuda.current_blas_handle()
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    new_state, res = body(state, inputs)
                    write_back(state_leaves, leaves(new_state))
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass        # the body's error is the one to raise
                    raise
                graph.capture_end()
        finally:
            counts = {k: n - before[k] for k, n in launch_counts().items()}
            for k, n in before.items():
                KERNELS[k].launches = n
            cur.wait_stream(self.stream)
        refs = [weakref.ref(t) for t in (*state_leaves.values(), *reads)]
        g = _Graph(graph, static, inputs, res,
                   {k: n for k, n in counts.items() if n}, refs)
        self._graphs[key] = g
        self.captures += 1
        return g
