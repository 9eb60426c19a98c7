"""Online inference: serve a trained checkpoint over HTTP on the card.

Port of `herald_tpu/serve.py`: the same HTTP API, the same request
handling, the same engine predict path the trainer validates with. Serves
checkpoints written by either package.

    python -m herald_tpu_torch.serve --ckpt runs/wdl/ckpt \
        --config runs/wdl/config.json --port 8976 [--device cuda]

API:
    GET  /health -> {"status": "ok", "model": ..., "step": N, "batch": B}
    POST /score  {"dense": [[...], ...], "sparse": [[...], ...]}
              -> {"probs": [...], "n": N}

Requests pad to the scoring batch (the training global batch by default,
`--batch` overrides) by repeating their last row, and chunk when larger.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from herald_tpu_torch.config import HeraldConfig
from herald_tpu_torch.models.base import get_model
from herald_tpu_torch.train.checkpoint import (apply_serve_overlay,
                                               load_checkpoint, load_extra,
                                               read_manifest)
from herald_tpu_torch.train.engine import Engine, TrainState


class Scorer:
    """Pads and chunks request rows through the engine's eval step."""

    def __init__(self, engine: Engine, state: TrainState):
        self.engine = engine
        self.state = state
        self.spec = engine.model.spec
        self.batch = engine.cfg.batch_size

    def score(self, dense: np.ndarray, sparse: np.ndarray) -> np.ndarray:
        n = len(sparse)
        nd = max(self.spec.num_dense, 0)
        dense = np.asarray(dense, np.float32).reshape(n, nd)
        sparse = np.asarray(sparse, np.int64).reshape(
            n, self.spec.num_sparse)
        if (sparse < 0).any() or (sparse >= self.engine.num_rows).any():
            raise ValueError(
                f"sparse ids out of range [0, {self.engine.num_rows})")
        probs = []
        B = self.batch
        for i in range(0, n, B):
            d, s = dense[i:i + B], sparse[i:i + B]
            m = len(s)
            if m < B:
                d = np.concatenate([d, np.repeat(d[-1:], B - m, axis=0)])
                s = np.concatenate([s, np.repeat(s[-1:], B - m, axis=0)])
            p = self.engine.predict(self.state, d, s)[:m]
            probs.append(p.cpu().numpy().reshape(-1))
        return np.concatenate(probs) if probs else np.zeros(0, np.float32)


def load_scorer(ckpt: str, cfg: HeraldConfig, table_rows: int = None,
                device=None) -> Scorer:
    """Build the engine the config describes and restore the checkpoint
    into it. `table_rows` must match the training run's (the trainer's
    --rows; default: the model's full table). A cached-state checkpoint
    serves through its base view, patched with its serve overlay where
    the save wrote one."""
    table_rows = table_rows or get_model(cfg.model).table_rows
    # one device, the plain engine, whatever layout the run trained in:
    # a row-sharded table is remapped on load, and the tower's parameters
    # are saved whole
    cfg = dataclasses.replace(cfg, comm_mode="local", mp_shards=1,
                              dense_sync_every=1, dense_sync_group=0,
                              use_cache=False, use_scheduler=False)
    eng = Engine(cfg, table_rows=table_rows, device=device)
    state = load_checkpoint(ckpt, eng.device, padded_rows=eng.padded_rows)
    if tuple(state.table.shape) != (eng.padded_rows, eng.width):
        raise ValueError(
            f"checkpoint table {tuple(state.table.shape)} does not fit "
            f"the engine's ({eng.padded_rows}, {eng.width}); pass the "
            f"training run's --rows and config")
    if read_manifest(ckpt)["state_type"] == "CachedTrainState":
        overlay = load_extra(ckpt, "serve_overlay")
        if overlay is not None:
            # a --ckpt-serve-view save: serve-exact even mid-stream
            state = apply_serve_overlay(state, overlay)
        else:
            warnings.warn(
                "serving a cached-state checkpoint through its base "
                "view: exact only if the checkpoint was written after "
                "sync_cache (the CLI's end-of-run save is; a periodic "
                "mid-stream --ckpt-every save is NOT — its owner table "
                "is missing the unflushed deltas of the hottest rows). "
                "Train with --ckpt-serve-view to make every checkpoint "
                "serve-exact via the overlay sidecar",
                UserWarning, stacklevel=2)
    return Scorer(eng, state)


def make_server(scorer: Scorer, port: int = 0) -> ThreadingHTTPServer:
    """HTTP server bound to 127.0.0.1:`port` (0 = ephemeral); call
    serve_forever(), on a thread if the caller goes on."""

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/health":
                return self._reply(404, {"error": "unknown path"})
            self._reply(200, {
                "status": "ok",
                "model": scorer.engine.model.name,
                "step": int(scorer.state.step),
                "batch": scorer.batch,
            })

        def do_POST(self):
            if self.path != "/score":
                return self._reply(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                probs = scorer.score(np.asarray(req.get("dense", [])),
                                     np.asarray(req["sparse"]))
                self._reply(200, {"probs": probs.tolist(),
                                  "n": int(len(probs))})
            except Exception as e:  # malformed request -> 400, keep serving
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *a):   # quiet; the caller owns logging
            pass

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def main(argv=None):
    ap = argparse.ArgumentParser(
        "herald_tpu_torch.serve", description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="checkpoint dir")
    ap.add_argument("--config", required=True,
                    help="HeraldConfig JSON (the trainer's --save-config)")
    ap.add_argument("--port", type=int, default=8976)
    ap.add_argument("--batch", type=int, default=None,
                    help="scoring batch (default: the training global "
                         "batch)")
    ap.add_argument("--rows", type=int, default=None,
                    help="table rows of the training run (its --rows; "
                         "default: the model's full table)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = HeraldConfig.from_json(f.read())
    if args.batch:
        cfg.batch_size = args.batch
    scorer = load_scorer(args.ckpt, cfg, table_rows=args.rows,
                         device=args.device)
    # warm up (kernel build and first launch) before accepting traffic
    nd = max(scorer.spec.num_dense, 0)
    scorer.score(np.zeros((1, nd)), np.zeros((1, scorer.spec.num_sparse)))
    srv = make_server(scorer, args.port)
    print(f"serving {scorer.engine.model.name} "
          f"(step {int(scorer.state.step)}) on {scorer.engine.device} at "
          f"http://127.0.0.1:{srv.server_address[1]}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
