"""Computation-graph visualizer (port of `herald_tpu/utils/graphboard.py`).

JAX lowers the engine's train step and prints XLA's program; torch has no
such program, so the port traces the train step's body with
`torch.fx.experimental.proxy_tensor.make_fx` on the engine's zero-filled
step args (`Engine.example_step_args`) and a fresh `init_state(0)`, as
`onnx/export.py` traces the tower, and writes the aten graph as graphviz
DOT text itself: one node per placeholder and op (its shape and dtype),
one edge per use. The trace runs on the CPU, where every kernel wrapper
takes its plain version: a kernel launched through ctypes leaves no
trace, so the engine must be a one-rank CPU engine (`device="cpu"`).
JAX's `stablehlo` and `hlo_opt` formats are XLA text and raise here.

Usage::

    from herald_tpu_torch.utils import graphboard
    src = graphboard.step_graph(eng, fmt="dot")   # render: dot -Tsvg
    graphboard.save(eng, "step.dot")
    graphboard.serve(eng, port=8000)             # one-page HTTP viewer
"""

from __future__ import annotations

import http.server
import torch


def _label(n: torch.fx.Node) -> str:
    """An fx node's text: its name or op, then its value's shape and dtype
    when it is one tensor."""
    head = n.name if n.op == "placeholder" else str(n.target).replace(
        ".default", "")
    val = n.meta.get("val")
    if isinstance(val, torch.Tensor):
        head += f"\\n{list(val.shape)} {str(val.dtype).replace('torch.', '')}"
    return head.replace('"', '\\"')


def _dot(gm: torch.fx.GraphModule) -> str:
    ids = {n: f"n{i}" for i, n in enumerate(gm.graph.nodes)}
    lines = ["digraph step {", '  node [shape=box, fontname="monospace"];']
    for n in gm.graph.nodes:
        shape = ", shape=ellipse" if n.op in ("placeholder", "output") \
            else ""
        lines.append(f'  {ids[n]} [label="{_label(n)}"{shape}];')
        for src in n.all_input_nodes:
            lines.append(f"  {ids[src]} -> {ids[n]};")
    lines.append("}")
    return "\n".join(lines) + "\n"


def step_graph(engine, fmt: str = "dot") -> str:
    """The engine's train step as text: its aten graph in graphviz DOT
    (`fmt="dot"`, the only format the port has), at the engine's batch."""
    from torch.fx.experimental.proxy_tensor import make_fx

    if fmt != "dot":
        raise ValueError(f"fmt {fmt!r}: the port writes the train step's "
                         f"graph in the 'dot' format only ('stablehlo' and "
                         f"'hlo_opt' are XLA text)")
    if engine.device.type != "cpu" or engine.num_shards > 1:
        raise ValueError("graphboard traces a one-rank engine on the CPU "
                         "(a CUDA kernel launched through ctypes leaves no "
                         "trace): build it with device='cpu'")

    def body(state, a):
        return engine._train_step_body(state, a)
    gm = make_fx(body)(engine.init_state(0), *engine.example_step_args())
    return _dot(gm)


def save(engine, path: str) -> str:
    """Write the step's DOT text to `path`."""
    src = step_graph(engine)
    with open(path, "w") as f:
        f.write(src)
    return path


def serve(engine, port: int = 8000):
    """Serve the step's DOT text on localhost. Blocks; ctrl-c to stop."""
    src = step_graph(engine).encode()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.end_headers()
            self.wfile.write(src)

        def log_message(self, *a):
            pass

    with http.server.HTTPServer(("127.0.0.1", port), Handler) as srv:
        print(f"graphboard: serving dot on http://127.0.0.1:{port}")
        srv.serve_forever()
