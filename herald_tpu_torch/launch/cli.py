"""Training launcher (port of `herald_tpu/launch/cli.py`).

    python -m herald_tpu_torch.launch --model wdl_criteo --bf16-table \
        --nepoch 1 --batch-size 256 --embedding-size 128 [--device cuda|cpu]
    python -m herald_tpu_torch.launch --model dfm_criteo --bf16-table \
        --batch-size 1024 --embedding-size 512 --rows 33762577
    python -m herald_tpu_torch.launch --scheduled [--pinned-rows P \
        --plan-cache DIR --device-data --autosize] [--device cuda|cpu]
    python -m torch.distributed.run --standalone --nproc-per-node S \
        -m herald_tpu_torch.launch --comm hybrid [--device cuda:0|cpu] \
        [--ckpt DIR --ckpt-every N | --resume DIR]
    python -m torch.distributed.run --nnodes N --node-rank I \
        --master-addr HOST --master-port PORT --nproc-per-node P \
        -m herald_tpu_torch.launch --comm hybrid --multihost [...]
    python -m herald_tpu_torch.launch.supervise --ckpt-dir DIR -- [...]

The flags are herald_tpu.launch's, plus `--device`; `--model` takes every
name of `herald_tpu_torch.models.available_models()`. `herald_tpu_torch/
bin/heraldrun` forwards to this module (`--supervise`: to
`launch/supervise.py`), and `herald_tpu_torch/examples/` holds the
counterparts of `examples/`. Ported:
- `--preprocess-raw FILE --data-path DIR` (`cli.py:613-619`): the raw
  criteo, avazu or criteosearch file becomes the six `.npy` files first
  (`data/preprocess.py`; files of 64 MB or more through the native
  parser, `csrc/herald_preproc.cc`, built by `sched/build.py`). Over S
  ranks rank 0 writes them and every rank waits at a barrier, then loads.
- the plain trainer (`cli.py:1126-1238`): init or `--resume`, chunks of
  `--scan-steps` steps through `Engine.train_epoch`, checkpoints at
  `--ckpt-every` crossings and at the end, `--max-steps`, a validation
  pass per finished epoch and at the end, and the same report. Under
  JAX's rule (prefetch on, no `--resume` past step 0, no `--max-steps`)
  a `data/prefetch.py` `DevicePrefetcher` stages the chunks ahead on a
  copy stream of its own, each rank its block of every global batch;
  otherwise, or with `--no-prefetch`, each chunk is staged when it runs.
  Unlike JAX's prefetcher (`data/prefetch.py:38-40`), which drops an
  epoch's last `steps % --scan-steps` steps, an epoch's last chunk is
  shorter, so both ways train the same steps in the same order.
  `--comm hybrid` runs it over the
  ranks of `torch.distributed.run` (`parallel/comm.py`; one rank without
  it): the table row-sharded over S ranks, global batches of
  `--batch-size * S` rows, gloo on the CPU or when the ranks share a card
  (`--device cuda:0` puts every local rank on card 0), NCCL when each rank
  has a card of its own. Every rank trains; rank 0 alone prints and
  writes the outputs, and the report names `devices` (S) and `backend`.
  Over S ranks every rank enters each checkpoint: it writes its own
  block of the table and slots, rank 0 the tower and the manifest
  (`train/checkpoint.py`), and `--resume` restores a checkpoint of any
  S, remapping the table when S differs;
- the scheduled branch (`cli.py:736-1069`): the lookahead planner (live,
  or a plan tape with `--plan-cache`) drives `CachedEngine` chunk by chunk,
  with `--pinned-rows` over frequency-remapped ids, `--device-data`,
  `--autosize` (and `--autosize-flush-budget`, with a wide engine for the
  cold steps), `--ckpt-serve-view`, `--resume` through `fast_forward`, an
  approximate per-epoch eval, the exact final eval after `sync_cache`, and
  the steady-state clock. Once the cold steps are done, `_Prestager`
  (`cli.py:444-555`) pops the stream on a thread of its own and stages
  `--prestage` chunks ahead through `--prestage-threads` workers, each
  copy on a copy stream (`all`: the whole stream before the first step;
  chosen by itself with `--plan-cache --device-data` when the stream fits
  `HERALD_PRESTAGE_BUDGET` bytes, 1 GiB by default); `--prestage 0` stages
  each chunk when it runs. The staged-chunk memo (`--no-chunk-memo`,
  `--chunk-memo-mb`) reuses a staged chunk equal to an earlier one, and
  the report counts `chunk_memo_hits` and says `chunk_memo_active` for
  both engines, as JAX's does; `HERALD_STATS_DEPTH` bounds the chunks
  whose stats stay on the card. Over S ranks (`--comm hybrid`) rank 0 alone
  plans for S workers and a `sched/service.py` `BroadcastPlanner` hands
  every rank each chunk over a gloo group of its own (and fast-forwards
  on `--resume`, which takes a
  checkpoint of the same S only: the cache arrays are the stream's),
  `--autosize` probes on rank 0 and broadcasts its
  sizes, the flush deltas cross the wire in `--bf16-flush` or
  `--int8-flush` form (accepted and unused on one rank, as in JAX), and
  `--plan-cache` and `--ckpt-serve-view` are refused with JAX's messages.
  Unlike `cli.py:993`, a `--max-steps` stop on an epoch boundary keeps
  that epoch's (approximate) eval;
- the FAE branch (`cli.py:665-708`; `--fae` or a `fae_*` model, with
  `--hot-rate`): `FaeEngine` step by step over the whole epochs, the
  hot-id LUT profiled from the training ids, `evaluate_fae` per epoch and
  at the end; over S ranks (`--comm hybrid`) global batches of
  `--batch-size * S` rows. As in JAX it writes no checkpoint and ignores
  `--ckpt`, `--resume`, `--max-steps` and `--crash-after` at every S,
  and with `--export-onnx` it exits with JAX's message before training
  (an FAE state has no exporter, as in JAX);
- assign-only mode (`--assign-only`, `cli.py:1070-1125`): the plain engine
  over the batches the lookahead scheduler (csrc/herald_sched.cc)
  composes for S workers (rank 0 plans, `sched/service.py` broadcasts
  each assignment), with checkpoints, `--max-steps`, `--resume` through a
  deterministic fast-forward of the scheduler, and its counters under
  `sched` in the report.
`--export-onnx PATH` (`cli.py:1208-1217`) writes the trained model as a
standard `.onnx` file after the final checkpoint (`onnx/export.py`
`export_state`), in the plain, assign-only and scheduled branches; a
scheduled run must end synced (no early stop), else it exits with JAX's
message. Over S ranks on one node every rank enters, rank 0 gathers the
table and writes the file; ranks on several nodes raise, as JAX's
export does when the table is not on one process.
`--crash-after N` ends every rank with exit code 17 once N steps have
run (rank 0 prints `{"crashed_at": N}`), for the restart supervisor
(`launch/supervise.py`). `--multihost` says that the ranks come from
`torch.distributed.run` over one or more nodes (`--nnodes`, each rank on
its LOCAL_RANK card), and raises without its environment; checkpoints
must then be on storage every node reads. `--mp-shards N` trains JAX's
tensor-parallel tower over the ranks' (S / N, N) grid in the plain and
assign-only branches (its checkpoints hold the tower's shards as blocks,
its export gathers them); with `--scheduled`, lamb or dense-sync it
raises JAX's config errors, with the FAE engine the port's. `--platform`
raises NotImplementedError naming its ROADMAP item; no flag is ignored.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch


def _prestage_arg(v: str) -> int:
    """--prestage accepts an int depth or 'all' (-1)."""
    if v == "all":
        return -1
    n = int(v)
    if n < 0:
        raise argparse.ArgumentTypeError("--prestage must be >= 0 or 'all'")
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="herald_tpu_torch.launch",
        description="embedding-model trainer on one CUDA card (the "
                    "PyTorch port of herald_tpu.launch)")
    p.add_argument("--config", default=None,
                   help="JSON HeraldConfig file (HeraldConfig.to_json "
                        "output) — the reference's yaml config-file "
                        "mechanism re-expressed; explicit flags override "
                        "individual fields")
    p.add_argument("--save-config", default=None,
                   help="write the resolved HeraldConfig JSON here and "
                        "continue (pair with --config to reproduce runs)")
    p.add_argument("--model", default="wdl_criteo")
    p.add_argument("--mp-shards", type=int, default=1,
                   help="tensor-parallel degree of the dense tower "
                   "(Megatron col/row sharding over an 'mp' mesh axis; "
                   "requires --comm hybrid and a TP-capable model: "
                   "wdl/dfm/dcn families)")
    p.add_argument("--dense-sync-every", type=int, default=1,
                   help="average dense params+slots over dp every K steps "
                        "instead of all-reducing grads every step (local "
                        "SGD with periodic model averaging; chunk "
                        "boundaries always sync). 1 = exact BSP")
    p.add_argument("--dense-sync-group", type=int, default=0,
                   help="per-step dense-grad all-reduce over static "
                        "subgroups of this many dp workers (PartialReduce "
                        "analog; 1 = purely local). 0 = whole axis (exact)")
    p.add_argument("--comm", default="local", choices=["local", "hybrid"],
                   help="local: single chip; hybrid: row-sharded table + "
                        "DP dense tower over all devices")
    p.add_argument("--scheduled", action="store_true",
                   help="enable the lookahead scheduler + hot-row cache "
                        "(the Herald mode; reference run_laia.py)")
    p.add_argument("--assign-only", action="store_true",
                   help="lookahead affinity placement WITHOUT the cache "
                        "(isolates the scheduling gain in the A/B ladder: "
                        "baseline / assign-only / scheduled / fae)")
    p.add_argument("--fae", action="store_true",
                   help="hot/cold split training (FAE baseline; reference "
                        "run_laia_fae.py). Implied by fae_* model names.")
    p.add_argument("--hot-rate", type=float, default=0.01,
                   help="FAE: fraction of table rows kept hot "
                        "(reference num_hot_emb ~= 1%% of rows)")
    p.add_argument("--batch-size", type=int, default=256,
                   help="per-worker batch size")
    p.add_argument("--embedding-size", type=int, default=128)
    p.add_argument("--opt", default="sgd")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--embed-lr", type=float, default=None,
                   help="embedding-table learning rate (default: --lr). "
                        "Sparse per-row updates tolerate a much higher "
                        "rate than the dense tower — the reference runs "
                        "the same split (run_laia.py passes separate "
                        "optimizer configs to the PS tier)")
    p.add_argument("--embed-opt", default=None,
                   help="embedding-table optimizer (default: --opt). "
                        "sgd keeps the cached path's deferred-flush "
                        "delta accumulation EXACTLY equivalent to "
                        "per-step updates; stateful optimizers see one "
                        "batched delta per flush instead "
                        "(docs/deviations.md)")
    p.add_argument("--nepoch", type=int, default=1)
    p.add_argument("--cache-limit-ratio", type=float, default=0.1)
    p.add_argument("--cache-policy", default="lru",
                   choices=["lru", "lfu", "lfuopt"],
                   help="hot-row cache eviction policy (reference --cache, "
                        "run_laia.py:350; lfuopt adds the permanent-store "
                        "graduation)")
    p.add_argument("--shuffle-seed", type=int, default=0,
                   help="scheduled mode: reshuffle the sample order every "
                        "epoch with this seed (0 = fixed epoch order like "
                        "the reference); deterministic, resume-safe")
    p.add_argument("--bound", type=int, default=0,
                   help="scheduled mode: bounded staleness — a cached row "
                        "stays usable until it missed more than BOUND "
                        "remote updates (reference HET --bound; 0 = "
                        "always refresh)")
    p.add_argument("--pinned-rows", type=int, default=0,
                   help="scheduled mode: keep the P hottest rows as a "
                        "replicated psum-updated block (three-tier: "
                        "pinned-hot / cached-warm / sharded-cold); ids are "
                        "frequency-remapped automatically")
    p.add_argument("--rows", type=int, default=None,
                   help="override embedding-table rows (scaled runs)")
    p.add_argument("--data-path", default=None,
                   help="dir with preprocessed .npy files (reference "
                        "load_data.py layout); default: synthetic")
    p.add_argument("--preprocess-raw", default=None,
                   help="raw dataset file (criteo train.txt / avazu "
                        "train.csv / CriteoSearchData); preprocessed into "
                        "--data-path first (reference download_* step)")
    p.add_argument("--samples", type=int, default=200_000,
                   help="synthetic sample count when no --data-path")
    p.add_argument("--val-ratio", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scan-steps", type=int, default=20,
                   help="steps per train_epoch call (one host-to-device "
                        "copy of the chunk)")
    p.add_argument("--a2a-capacity-factor", type=float, default=2.0,
                   help="all-to-all bucket capacity per (src,dst) pair = "
                        "ceil(uniques/shards) * factor; raise it if the "
                        "run aborts with an exchange-overflow error")
    p.add_argument("--device-data", action="store_true",
                   help="scheduled mode: pre-stage the FULL dataset in "
                   "HBM (replicated) and gather sample rows on device by "
                   "assignment index — host ships ~KB of indices per "
                   "step instead of ~MB of rows. Use when the dataset "
                   "fits next to the table")
    p.add_argument("--no-prefetch", action="store_true",
                   help="disable the async host->device input pipeline "
                        "(data/prefetch.py DevicePrefetcher)")
    p.add_argument("--no-chunk-memo", action="store_true",
                   help="disable the staged-chunk memo (scheduled mode: "
                        "repeated epochs reuse byte-identical staged "
                        "program buffers, eliding the device_put; "
                        "bit-exact — this flag exists for staging "
                        "debugging and ablation)")
    p.add_argument("--chunk-memo-mb", type=int, default=None,
                   help="staged-chunk memo budget in MB (default 256). "
                        "The memo only pays off on streams that reach "
                        "their cache fixed point (working set inside "
                        "the cache: programs byte-identical across "
                        "epochs) — size the window to one epoch's "
                        "distinct program bytes then. Streams whose "
                        "working set exceeds the cache never repeat "
                        "(measured: 0 hits at any budget, docs/"
                        "OPERATIONS.md) and the memo disables itself "
                        "after churning 4x the budget; oversizing "
                        "risks HBM, never correctness")
    p.add_argument("--autosize", action="store_true",
                   help="scheduled mode: run a host-only probe plan first "
                        "and size everything from measurements — program "
                        "widths (unique/flush slots), all-to-all "
                        "capacities, and the pull-smoothing target; the "
                        "first --autosize-warmup steps run on a "
                        "wide-capacity program (cold caches), the rest on "
                        "the tight steady-state program")
    p.add_argument("--autosize-warmup", type=int, default=8)
    p.add_argument("--autosize-flush-budget", action="store_true",
                   help="with --autosize: also sweep the planned-flush "
                        "budget (sizing.sweep_flush_budget) and size the "
                        "flush wire from the measured post-deferral "
                        "maxima. Opt-in because deferral trades row "
                        "freshness for traffic (bounded-staleness, the "
                        "reference's --bound spirit): rows a remote "
                        "worker reads may miss deltas the holder has "
                        "not flushed yet")
    p.add_argument("--crash-after", type=int, default=0,
                   help="FAULT INJECTION: hard-exit(17) once N steps have "
                        "run (ignored under --resume) — exercises the "
                        "supervisor/checkpoint/resume path "
                        "(launch/supervise.py); the reference has no "
                        "fault-injection harness (SURVEY §5)")
    p.add_argument("--export-onnx", default=None, metavar="PATH",
                   help="write the trained model as a standard .onnx "
                   "file at end of run (serving handoff; reference "
                   "hetu2onnx.export). Scheduled runs must finish "
                   "(fully-synced state)")
    p.add_argument("--ckpt", default=None, help="checkpoint dir")
    p.add_argument("--ckpt-serve-view", action="store_true",
                   help="scheduled mode, single process: write a "
                        "serve-exact overlay (the synced values of rows "
                        "whose deltas are still cache-parked) next to "
                        "every checkpoint — mid-stream --ckpt-every "
                        "saves then SERVE exactly (herald_tpu_torch.serve "
                        "applies it automatically) instead of the "
                        "warn-path approximation; resume stays bit-exact "
                        "either way (the raw state is unchanged)")
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="also checkpoint every N steps (elastic/failure "
                        "recovery: kill + --resume continues bit-exactly; "
                        "replaces the reference's Van heartbeat/rejoin, "
                        "ps-lite/src/van.cc:104-116)")
    p.add_argument("--resume", default=None, help="checkpoint to load; "
                   "training continues from the SAVED step (the planner "
                   "fast-forwards deterministically in scheduled mode)")
    p.add_argument("--max-steps", type=int, default=0,
                   help="stop after N optimizer steps; with --ckpt this "
                        "produces a resumable mid-run checkpoint (the "
                        "scheduled path skips the final cache sync — the "
                        "unflushed deltas are part of the checkpoint)")
    p.add_argument("--log-dir", default=None,
                   help="write run artifacts here: report.json, per-step "
                        "losses.npy, and a torch.profiler trace of the "
                        "training loop (reference analog: run_laia.py's "
                        "per-iteration/epoch log files)")
    p.add_argument("--multihost", action="store_true",
                   help="ranks over one or more nodes, from the environment "
                        "of torch.distributed.run (--nnodes N); raises "
                        "without it. Checkpoints must be on storage that "
                        "every node reads")
    p.add_argument("--bf16-table", action="store_true")
    flushw = p.add_mutually_exclusive_group()
    flushw.add_argument("--bf16-flush", action="store_true",
                        help="scheduled mode: compress flush gradient "
                             "deltas to bf16 on the wire (halves flush "
                             "all-to-all bytes; owner-side accumulation "
                             "stays f32 — one quantization per flush)")
    flushw.add_argument("--int8-flush", action="store_true",
                        help="scheduled mode: int8 flush deltas with "
                             "per-row scales and exact error feedback "
                             "(the residual rides the slot's delta "
                             "accumulator) — ~4x fewer flush bytes than "
                             "f32, ~2x fewer than bf16")
    p.add_argument("--prestage", type=_prestage_arg, default=3,
                   metavar="DEPTH|all",
                   help="scheduled mode: keep up to DEPTH chunks popped "
                        "+ staged to the card AHEAD of the training loop "
                        "(a pop thread + small staging pool, copies on a "
                        "stream of their own). 0 disables (per-chunk "
                        "staging). 'all' stages the ENTIRE stream to the "
                        "card before the first dispatch — the timed loop "
                        "is then pure dispatch (budget: the bytes of a "
                        "staged step x total steps of device memory; "
                        "pair with --plan-cache + --device-data). "
                        "Exactness is untouched in every mode: the "
                        "chunk stream is identical and serve-view "
                        "residency mirrors advance at dispatch time")
    p.add_argument("--prestage-threads", type=int, default=2,
                   help="staging pool width for --prestage (chunks packed "
                        "and copied at once; raise if staging wall time "
                        "still exceeds device execution per chunk)")
    p.add_argument("--plan-cache", default=None, metavar="DIR",
                   help="scheduled mode, single process: record the "
                        "planner's micro-program tape here on first run "
                        "and REPLAY it on later runs with the same "
                        "(stream, config) — zero planning cost on the "
                        "training host (the stream is fixed per job, "
                        "like the reference's Laia epoch matrix)")
    p.add_argument("--platform", default=None,
                   help="herald_tpu.launch's JAX platform switch; the port "
                        "raises on it and takes --device instead")
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: cuda; the "
                        "launcher raises when there is no card unless "
                        "given --device cpu)")
    return p



# flags of herald_tpu.launch the port does not run yet, each with the
# ROADMAP item (queue 1) that brings it
_NOT_PORTED = (
    ("platform", "--platform", "none: it is JAX's platform switch; use "
     "--device"),
)


def _uses_fae(args, cfg) -> bool:
    """--fae, or a fae_* model, which herald_tpu.launch trains as if given
    --fae."""
    from herald_tpu_torch.models import get_model
    return args.fae or get_model(cfg.model).train_engine == "fae"


def _refuse_unported(args, cfg) -> None:
    if _uses_fae(args, cfg) and args.export_onnx:
        # herald_tpu.launch's refusal, before any training (cli.py:667-673)
        raise SystemExit("--export-onnx does not support FAE runs "
                         "(hot/cold split state); train the plain or "
                         "scheduled mode to export")
    for attr, flag, item in _NOT_PORTED:
        if getattr(args, attr):
            raise NotImplementedError(
                f"{flag} is not ported to herald_tpu_torch yet "
                f"(ROADMAP queue 1, {item})")
    if args.multihost and "WORLD_SIZE" not in os.environ:
        # where JAX's jax.distributed.initialize() finds no cluster
        raise ValueError(
            "--multihost takes its ranks from torch.distributed.run "
            "(WORLD_SIZE, RANK, MASTER_ADDR, ...): launch with python -m "
            "torch.distributed.run --nnodes N --nproc-per-node P ... -m "
            "herald_tpu_torch.launch --comm hybrid --multihost")
    from herald_tpu_torch.parallel.comm import world_size
    S = world_size() if cfg.comm_mode == "hybrid" else 1
    if S == 1:
        return
    # herald_tpu.launch's own one-process rules (cli.py:813-818, 850-854)
    if args.scheduled and args.plan_cache:
        raise ValueError(
            "--plan-cache is single-process only: multi-process "
            "jobs fan live programs out through BroadcastPlanner "
            "(one planner per job); drop the flag")
    if args.ckpt_serve_view:
        raise ValueError("--ckpt-serve-view is single-process only "
                         "(the overlay reads global arrays)")


def resolve_config(args) -> "HeraldConfig":
    """Build the run's HeraldConfig from a JSON file and/or flags, with
    herald_tpu.launch's override rules."""
    from herald_tpu_torch.config import HeraldConfig
    if args.config:
        # the JSON is the base; flags set on the command line override
        # their fields (detected by differing from the parser default:
        # passing a flag AT its default while the file differs keeps the
        # file's value)
        with open(args.config) as f:
            cfg = HeraldConfig.from_json(f.read())
        dflt = build_parser().parse_args([])
        for ak, ck in [("model", "model"), ("batch_size", "batch_size"),
                       ("embedding_size", "embedding_dim"),
                       ("comm", "comm_mode"), ("opt", "optimizer"),
                       ("lr", "learning_rate"),
                       ("cache_limit_ratio", "cache_limit_ratio"),
                       ("cache_policy", "cache_policy"),
                       ("seed", "seed"), ("bound", "staleness_bound"),
                       ("pinned_rows", "pinned_rows"),
                       ("shuffle_seed", "sched_shuffle_seed"),
                       ("log_dir", "log_dir"),
                       ("mp_shards", "mp_shards"),
                       ("dense_sync_every", "dense_sync_every"),
                       ("dense_sync_group", "dense_sync_group"),
                       ("a2a_capacity_factor", "a2a_capacity_factor")]:
            if getattr(args, ak) != getattr(dflt, ak):
                setattr(cfg, ck, getattr(args, ak))
        # the JSON stores the post-resolved embed fields; a flag override
        # of lr/opt re-resolves them
        if args.lr != dflt.lr:
            cfg.embed_learning_rate = args.lr
        if args.opt != dflt.opt:
            cfg.embed_optimizer = args.opt
        if args.embed_lr is not None:
            cfg.embed_learning_rate = args.embed_lr
        if args.embed_opt is not None:
            cfg.embed_optimizer = args.embed_opt
        if args.scheduled:
            cfg.use_cache = cfg.use_scheduler = True
        if not (cfg.use_scheduler and cfg.use_cache):
            cfg.pinned_rows = 0     # same gate as the flag path
        if args.no_prefetch:
            cfg.prefetch = False
        if args.no_chunk_memo:
            cfg.sched_chunk_memo = False
        if args.chunk_memo_mb is not None:
            cfg.sched_chunk_memo_mb = args.chunk_memo_mb
        if args.bf16_table:
            cfg.table_dtype = torch.bfloat16
        if args.bf16_flush:
            cfg.flush_wire_dtype = torch.bfloat16
        if args.int8_flush:
            cfg.flush_wire_dtype = torch.int8
        args.scheduled = bool(cfg.use_scheduler and cfg.use_cache)
        # the overrides above bypassed dataclass construction: validate
        cfg.__post_init__()
    else:
        cfg = HeraldConfig(
            model=args.model, batch_size=args.batch_size,
            embedding_dim=args.embedding_size, comm_mode=args.comm,
            optimizer=args.opt, learning_rate=args.lr,
            embed_learning_rate=args.embed_lr,
            embed_optimizer=args.embed_opt,
            cache_limit_ratio=args.cache_limit_ratio,
            cache_policy=args.cache_policy, seed=args.seed,
            use_cache=args.scheduled, use_scheduler=args.scheduled,
            pinned_rows=args.pinned_rows if args.scheduled else 0,
            staleness_bound=args.bound,
            sched_shuffle_seed=args.shuffle_seed,
            a2a_capacity_factor=args.a2a_capacity_factor,
            prefetch=not args.no_prefetch,
            sched_chunk_memo=not args.no_chunk_memo,
            sched_chunk_memo_mb=(args.chunk_memo_mb
                                 if args.chunk_memo_mb is not None
                                 else HeraldConfig.sched_chunk_memo_mb),
            log_dir=args.log_dir,
            flush_wire_dtype=(torch.int8 if args.int8_flush
                              else torch.bfloat16 if args.bf16_flush
                              else None),
            table_dtype=torch.bfloat16 if args.bf16_table
            else torch.float32,
            mp_shards=args.mp_shards,
            dense_sync_every=args.dense_sync_every,
            dense_sync_group=args.dense_sync_group)
    return cfg


def _dump_logs(args, report, losses) -> None:
    """Run artifacts: report.json and the per-step losses.npy."""
    if not args.log_dir:
        return
    os.makedirs(args.log_dir, exist_ok=True)
    np.save(os.path.join(args.log_dir, "losses.npy"),
            np.asarray(losses, np.float32))
    with open(os.path.join(args.log_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2, default=float)


def _check_resumed(eng, state, path) -> None:
    """A checkpoint must fit the engine it resumes: the rank's block of
    the table (the whole table on one device) and its dtype, the
    optimizers' slots, and for a cached run the cache and hot block."""
    want = (eng.exchange.rows_per_shard, eng.width)
    if tuple(state.table.shape) != want \
            or state.table.dtype != eng.cfg.table_dtype:
        raise ValueError(
            f"--resume {path}: table {tuple(state.table.shape)} "
            f"{state.table.dtype} does not fit the run's {want} "
            f"{eng.cfg.table_dtype}; pass the training run's --rows, "
            f"config and --bf16-table")
    slots = set(eng.embed_opt.slot_names)
    dslots = set(eng.dense_opt.slot_names)
    if set(state.table_slots) != slots or any(
            set(state.dense_slots.get(k, {})) != dslots
            for k in state.dense):
        raise ValueError(
            f"--resume {path}: the checkpoint's optimizer slots "
            f"{sorted(state.table_slots)} do not match --embed-opt "
            f"{eng.embed_opt.name} / --opt {eng.dense_opt.name}")
    if hasattr(state, "cache"):
        got = (tuple(state.cache.shape), tuple(state.hot_table.shape))
        need = ((eng.cache_rows, 2 * eng.width),
                (max(eng.pinned_rows, 1), eng.width))
        if got != need:
            raise ValueError(
                f"--resume {path}: cache {got[0]} and hot block {got[1]} "
                f"do not fit the run's {need[0]} and {need[1]}; pass the "
                f"training run's cache and --pinned-rows settings")


class _ChunkStats:
    """Per-chunk stats read back at boundaries (the JAX launcher's
    `_ChunkStats`, `cli.py:385-440`): the losses of the chunks in flight
    stay on the device until an epoch, checkpoint or the end needs them, so
    the loop itself never waits for the card. `HERALD_STATS_DEPTH=N`
    bounds the chunks in flight, as in JAX: past N the oldest is read back
    (a wait for the card) while the loop goes on."""

    def __init__(self, depth: Optional[int] = None):
        if depth is None:
            depth = int(os.environ.get("HERALD_STATS_DEPTH", 1 << 20))
        self.depth = max(depth, 1)
        self.pending = []
        self.losses = []
        self.overflow = 0

    def push(self, stats) -> None:
        self.pending.append(stats)
        while len(self.pending) > self.depth:
            self._take([self.pending.pop(0)])

    def _take(self, pending) -> None:
        loss = torch.cat([st["loss"].reshape(-1) for st in pending])
        over = torch.stack([st["overflow"].sum() for st in pending])
        self.losses.extend(loss.cpu().tolist())
        self.overflow += int(over.sum())

    def drain(self) -> None:
        if self.pending:
            pending, self.pending = self.pending, []
            self._take(pending)

    def finish(self):
        self.drain()
        return self.losses, self.overflow


class _Prestager:
    """The scheduled path's staging pipeline (JAX's `_Prestager`,
    `cli.py:444-555`): a producer thread pops the planner stream in order,
    clamping chunks at epoch boundaries and at the step target as the
    per-chunk loop does and never popping past the target, and hands each
    chunk to a pool of `threads` workers that run
    `CachedEngine._stage_chunk` on a copy stream (`data/prefetch.py`
    `CopyStream`). Chunks come back in stream order through a queue of
    `depth` (0: unbounded, for prestage-all), so the pops, the packing and
    the host-to-device copies overlap the steps of earlier chunks.

    Exactness is untouched: the chunks, their order and contents are the
    per-chunk path's (each pop allocates fresh arrays), and residency
    tracking (`--ckpt-serve-view`) is applied by the consumer when it
    dispatches a chunk, so the host mirror never runs ahead of the steps.
    Over S ranks the producer's pops are `BroadcastPlanner` broadcasts,
    which go over a group of their own (`Comm.host_group`), never the
    group the steps' collectives use."""

    _END = object()

    def __init__(self, eng, planner, trn, device_data, start_done, target,
                 spe, scan_steps, depth, threads):
        from herald_tpu_torch.data.prefetch import CopyStream
        self.eng = eng
        self.q = queue.Queue(maxsize=max(depth, 0))
        self._stop = threading.Event()
        self._pool = ThreadPoolExecutor(max_workers=max(threads, 1),
                                        thread_name_prefix="herald-stage")
        self._copies = CopyStream(eng.device)
        self._cfg = (planner, trn, device_data, start_done, target, spe,
                     scan_steps)
        self._err = None
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="herald-prestager")
        self._thread.start()

    def _produce(self) -> None:
        planner, trn, device_data, done, target, spe, scan = self._cfg
        track = self.eng._slot2id is not None
        idx_feed = device_data is not None
        raw = {} if idx_feed else {"raw_dense": trn[0],
                                   "raw_sparse": trn[1],
                                   "raw_labels": trn[2]}
        try:
            while done < target and not self._stop.is_set():
                k = min(scan, target - done,
                        spe - done % spe if done % spe else spe)
                out = planner.pop_chunk(k)
                K = out[0]
                if K == 0:
                    break
                tr = (K, out[2], out[6], out[7], out[8]) if track else None
                fut = self._pool.submit(self._copies.run,
                                        self.eng._stage_chunk, *out,
                                        index_feed=idx_feed, **raw)
                if not self._put((fut, tr)):
                    return
                done += K
                if K < k:       # the stream ended short of the request
                    break
        except BaseException as e:      # raised again by get()
            self._err = e
        finally:
            self._put(self._END)

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def await_staged(self) -> None:
        """Block until the whole stream is popped and its copies issued
        (prestage-all): the loop is then pure dispatch."""
        self._thread.join()
        self._pool.shutdown(wait=True)

    def get(self):
        """The next staged chunk as (StagedChunk, residency args or None),
        ready on the caller's current stream; None at the end of the
        stream. Raises the producer's or a worker's error. Under a
        profiler, the wait is the span `launch.stage_wait`."""
        from herald_tpu_torch.utils.profiler import span
        with span("launch.stage_wait"):
            item = self.q.get()
            if item is self._END:
                if self._err is not None:
                    raise self._err
                return None
            fut, tr = item
            staged, event = fut.result()
        self._copies.ready(staged.packed, event)
        return staged, tr

    def close(self) -> None:
        self._stop.set()
        while True:     # unblock a producer waiting on a full queue
            try:
                self.q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10)
        self._pool.shutdown(wait=False, cancel_futures=True)


def _fail_on_overflow(total: int) -> None:
    """The JAX launcher's abort on rows dropped by the exchange's static
    buckets (one device has no exchange: the count stays 0), beside every
    checkpoint and after training, as in JAX."""
    if total > 0:
        raise RuntimeError(
            f"exchange overflow: {total} embedding rows were dropped this "
            f"run; results up to now trained on zero-filled rows")


def _autosize(cfg, rows, trn, args, device, comm):
    """`--autosize`: size the program widths, capacities and pull target
    from a host-only probe plan, as the JAX launcher does
    (`cli.py:739-808`). The probe plans for all S workers once: over S
    ranks rank 0 alone runs it and broadcasts the seven sizes. Returns
    the wide engine for the cold steps and their count."""
    from herald_tpu_torch.config import HeraldConfig
    from herald_tpu_torch.train.cached import CachedEngine
    S = comm.size if comm else 1
    sizes = (_probe_sizes(cfg, rows, trn, args, device, S)
             if comm is None or comm.rank == 0 else None)
    if S > 1:
        from herald_tpu_torch.sched.service import broadcast_arrays
        sizes = broadcast_arrays(comm, [sizes], [(7,)], [np.int64])[0]
    (cfg.sched_unique_slots, cfg.sched_flush_slots, cfg.sched_pull_target,
     cfg.a2a_pull_capacity, cfg.a2a_flush_capacity, W,
     budget) = (int(v) for v in sizes)
    cfg.sched_flush_budget = budget or None
    # the cold steps run on the wide-capacity engine (empty caches pull
    # everything); the same program widths, so the planner's padded
    # buffers fit both engines
    cold_cfg = HeraldConfig(**{**cfg.__dict__, "a2a_pull_capacity": None,
                               "a2a_flush_capacity": None})
    return CachedEngine(cold_cfg, table_rows=rows, device=device), W


def _probe_sizes(cfg, rows, trn, args, device, S: int) -> np.ndarray:
    """The seven `--autosize` sizes of a probe plan for S workers: unique
    and flush slots, pull target, pull and flush capacities, warm-up
    steps, flush budget (0: none). Makes no collective call: its probe
    engines run no dense sync."""
    from herald_tpu_torch.config import HeraldConfig
    from herald_tpu_torch.sched.sizing import (TrafficProfile,
                                               hoist_target_candidates,
                                               profile_planned_traffic,
                                               sweep_flush_budget,
                                               sweep_hoist_sizing)
    from herald_tpu_torch.train.cached import CachedEngine
    cfg = HeraldConfig(**{**cfg.__dict__, "dense_sync_every": 1,
                          "dense_sync_group": 0})
    probe_eng = CachedEngine(cfg, table_rows=rows, device=device)
    # with per-epoch reshuffling later epochs batch differently: probe
    # several permutations so the caps cover them
    probe_epochs = min(args.nepoch, 3) if cfg.sched_shuffle_seed else 1
    probe = probe_eng.make_planner(trn[1], epochs=probe_epochs,
                                   n_threads=cfg.sched_threads)
    steps_prof, _ = profile_planned_traffic(probe, trn[1], S)
    probe.close()
    W = min(args.autosize_warmup, len(steps_prof) // 2)
    steady = TrafficProfile.from_steps(steps_prof[W:])
    full = TrafficProfile.from_steps(steps_prof)
    target, steady_h = sweep_hoist_sizing(
        cfg, rows, trn[1], S, W, hoist_target_candidates(steady, S, S),
        epochs=probe_epochs, n_threads=cfg.sched_threads)
    budget = 0
    if args.autosize_flush_budget:
        hoist_cfg = HeraldConfig(**{**cfg.__dict__,
                                    "sched_pull_target": int(target)})
        budget, steady_h = sweep_flush_budget(
            hoist_cfg, rows, trn[1], S, W, steady_h, epochs=probe_epochs,
            n_threads=cfg.sched_threads)
        budget = budget or 0
    return np.array([full.unique_slots(), full.flush_slots(), target,
                     steady_h.pull_capacity(), steady_h.flush_capacity(), W,
                     budget], np.int64)


def _train_scheduled(args, cfg, rows, trn, device, comm, eval_epoch,
                     maybe_ckpt, ckpt_extras, timer):
    """The scheduled branch of the JAX launcher (`cli.py:736-1069`), on one
    device or over the S ranks of `comm`. Returns (engine, state, losses,
    overflow, stopped_early, report extras)."""
    from herald_tpu_torch.sched.service import BroadcastPlanner
    from herald_tpu_torch.train.cached import CachedEngine
    from herald_tpu_torch.train.checkpoint import (load_cached_checkpoint,
                                                   load_extra)
    from herald_tpu_torch.utils.profiler import cache_report

    eng_cold, warm_steps = None, 0
    if args.autosize:
        eng_cold, warm_steps = _autosize(cfg, rows, trn, args, device, comm)
    eng = CachedEngine(cfg, table_rows=rows, device=device)
    S = eng.num_shards
    if S > 1:
        # one planner for the job, on rank 0; every rank gets its chunks
        # over a group of their own (the prestager pops on its thread)
        planner = BroadcastPlanner(
            lambda: eng.make_planner(trn[1], epochs=args.nepoch,
                                     n_threads=cfg.sched_threads),
            comm.host_group(), num_samples=len(trn[1]), nrank=S,
            batch_size=cfg.batch_size, unique_cap=eng.U_cap,
            flush_cap=eng.F_cap, cache_rows=eng.cache_rows,
            epochs=args.nepoch, prefetch_cap=eng.P_cap,
            num_tables=eng.model.spec.num_sparse)
    elif args.plan_cache:
        from herald_tpu_torch.sched.replay import plan_cache
        planner = plan_cache(eng, trn[1], args.plan_cache,
                             epochs=args.nepoch, n_threads=cfg.sched_threads)
    else:
        planner = eng.make_planner(trn[1], epochs=args.nepoch,
                                   n_threads=cfg.sched_threads)
    steps_total = planner.batch_num * args.nepoch
    done = 0
    if args.resume:
        # continue from the saved position: the checkpoint holds the cache
        # arrays mid-stream, and the deterministic planner fast-forwards
        # to the same batch
        state = load_cached_checkpoint(args.resume, eng.device, eng.comm)
        _check_resumed(eng, state, args.resume)
        done = int(state.step)
        skipped = planner.fast_forward(done)
        assert skipped == done, (skipped, done)
    else:
        state = eng.init_cached_state(cfg.seed)
    if args.ckpt_serve_view:
        mirror = None
        if args.resume:
            ov = load_extra(args.resume, "serve_overlay")
            if ov is None:
                raise ValueError(
                    "--ckpt-serve-view --resume needs a checkpoint that was "
                    "itself written with --ckpt-serve-view (the residency "
                    "mirror rides the overlay)")
            mirror = ov["mirror"]
        eng.enable_residency_tracking(mirror)
        if eng_cold is not None:
            eng_cold._slot2id = eng._slot2id     # one mirror for both
        ckpt_extras[0] = lambda st: {"serve_overlay": eng.serve_overlay(st)}
    target = min(steps_total, args.max_steps) if args.max_steps \
        else steps_total
    dev_data = eng.stage_dataset(*trn) if args.device_data else None
    cs = _ChunkStats()
    spe = planner.batch_num
    start_done = done
    final_eval_losses = None
    # steady clock: past the first chunks (CUDA and kernel start-up), at a
    # drained boundary, up to the final drain; eval and checkpoint time
    # are cut out of it (JAX: cli.py:877-903)
    warm_chunks = int(os.environ.get("HERALD_STEADY_WARM_CHUNKS", 4))
    steady = {"t0": None, "done0": 0, "chunks": 0, "elapsed": 0.0,
              "steps": 0, "segments": []}

    def steady_close():
        if steady["t0"] is not None:
            dt = time.perf_counter() - steady["t0"]
            ds = done - steady["done0"]
            steady["elapsed"] += dt
            steady["steps"] += ds
            if ds:
                steady["segments"].append((ds, dt))
            steady["t0"] = None

    def steady_open():
        steady["t0"] = time.perf_counter()
        steady["done0"] = done

    prestage = args.prestage
    if prestage > 0 and args.plan_cache and args.device_data:
        # the whole stream staged before the first step when it fits the
        # budget (JAX's cli.py:904-926): the bytes of a step's packed row
        est = eng.staged_step_bytes() * (target - done)
        if est <= int(os.environ.get("HERALD_PRESTAGE_BUDGET", 1 << 30)):
            print(json.dumps({
                "prestage": "all", "est_bytes": est,
                "note": "program stream fits HERALD_PRESTAGE_BUDGET; "
                        "staging everything before the first dispatch"}),
                flush=True)
            prestage = -1
    prestager = None
    try:
        while done < target:
            run_eng = eng_cold if (eng_cold is not None
                                   and done < warm_steps) else eng
            if prestage and prestager is None and run_eng is eng:
                # past the cold steps: stage from the stream's position
                prestager = _Prestager(
                    eng, planner, trn, dev_data, done, target, spe,
                    args.scan_steps, depth=max(prestage, 0),
                    threads=args.prestage_threads)
                if prestage == -1:
                    prestager.await_staged()
            if prestager is not None:
                item = prestager.get()
                if item is None:
                    break
                staged, tr = item
                if tr is not None:
                    eng._track_residency(*tr)
                with timer:
                    state, stats = eng.train_epoch_staged(
                        state, staged, device_data=dev_data)
            else:
                # chunks stop at epoch boundaries, so each eval sees one
                # epoch
                k = min(args.scan_steps, target - done,
                        spe - done % spe if done % spe else spe)
                if run_eng is eng_cold:
                    k = min(k, warm_steps - done)
                with timer:
                    state, stats = run_eng.train_epoch_cached(
                        state, planner, *trn, steps=k, device_data=dev_data)
                if stats is None:
                    break
            cs.push(stats)
            done += int(stats["loss"].shape[0])     # the executed count
            steady["chunks"] += 1
            if steady["chunks"] == warm_chunks and done < target:
                cs.drain()
                steady_open()
            if maybe_ckpt(eng, state, done, pre=lambda: (
                    cs.drain(), steady_close(),
                    _fail_on_overflow(cs.overflow))) \
                    and done < target and steady["chunks"] >= warm_chunks:
                steady_open()
            if done % spe == 0 and done > start_done:
                cs.drain()
                steady_close()
                losses_ep = cs.losses[-(done - max(start_done,
                                                   done - spe)):]
                if done >= steps_total:
                    # the last epoch of the stream: its eval waits for
                    # sync_cache, so it is exact
                    final_eval_losses = losses_ep
                    continue
                eval_epoch(eng, state, done // spe - 1, losses_ep,
                           approx=True)
                if steady["chunks"] >= warm_chunks:
                    steady_open()
    finally:
        if prestager is not None:
            prestager.close()
    losses, overflow_total = cs.finish()
    steady_close()
    _fail_on_overflow(overflow_total)
    stopped_early = done < steps_total
    if not stopped_early:
        # an early stop leaves the stream undrained: the unflushed deltas
        # live in the checkpoint and --resume continues them
        state = (eng_cold or eng).sync_cache(state, planner)
        eng._unsynced = False
        if final_eval_losses is not None:
            eval_epoch(eng, state, done // spe - 1, final_eval_losses)
    gb = cfg.batch_size * S
    extra = {
        "cache": cache_report(planner, done, eng.ids_per_worker),
        # train-loop-only throughput, evals and start-up excluded
        "examples_per_sec_steady": (steady["steps"] * gb / steady["elapsed"]
                                    if steady["steps"] else None),
        "examples_per_sec_steady_segments": [
            round(ds * gb / max(dt, 1e-6), 1)
            for ds, dt in steady["segments"]],
        "timing_steps_per_call": args.scan_steps,
        "chunk_memo_hits": eng.memo_hits + (eng_cold.memo_hits
                                            if eng_cold is not None else 0),
        "chunk_memo_active": bool(eng._memo_on or (
            eng_cold is not None and eng_cold._memo_on)),
        "noflush_chunks": eng.noflush_chunks + (
            eng_cold.noflush_chunks if eng_cold is not None else 0),
        "nopull_chunks": eng.nopull_chunks + (
            eng_cold.nopull_chunks if eng_cold is not None else 0),
    }
    return eng, state, losses, overflow_total, stopped_early, extra


def _train_fae(args, cfg, rows, trn, val, device, eval_epoch,
               epoch_records, timer, t_start, lead) -> dict:
    """The FAE branch of the JAX launcher (`cli.py:665-708`): every step of
    every epoch, one global batch (`batch_size * S` rows) at a time; a
    per-epoch eval and a final one through `evaluate_fae`. It returns its
    report before any checkpoint, as JAX's does. Losses and overflow stay
    on the card until an epoch ends."""
    from herald_tpu_torch.train.fae import FaeEngine, build_hot_lut
    from herald_tpu_torch.utils.profiler import start_trace
    eng = FaeEngine(cfg, table_rows=rows, hot_rate=args.hot_rate,
                    device=device)
    lut, _ = build_hot_lut(trn[1], rows, num_hot=eng.num_hot)
    state = eng.init_fae_state(cfg.seed)
    prof = start_trace(device) if args.log_dir and lead else None
    gb = cfg.batch_size * eng.num_shards
    steps_per_epoch = len(trn[1]) // gb
    losses = []
    overflow_total = 0
    for ep in range(args.nepoch):
        epoch, overflow = [], []
        for s in range(steps_per_epoch):
            lo = s * gb
            with timer:
                state, stats = eng.train_step_fae(
                    state, lut, trn[0][lo:lo + gb], trn[1][lo:lo + gb],
                    trn[2][lo:lo + gb])
            epoch.append(stats["loss"])
            overflow.append(stats["overflow"])
        if epoch:
            losses.extend(torch.stack(epoch).cpu().tolist())
            overflow_total += int(torch.stack(overflow).sum())
        eval_epoch(eng, state, ep, losses[-steps_per_epoch:], lut=lut)
    train_time = time.perf_counter() - t_start
    if prof is not None:
        prof.stop()
        os.makedirs(args.log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.log_dir, "trace.json"))
    _fail_on_overflow(overflow_total)
    res = eng.evaluate_fae(state, lut, *val)
    report = {
        "model": cfg.model, "mode": "fae", "comm": cfg.comm_mode,
        "devices": eng.num_shards,
        **({"backend": eng.comm.backend} if eng.comm else {}),
        "device": str(eng.device), "steps": len(losses),
        "train_loss_last": float(np.mean(losses[-20:])) if losses else None,
        "val_auc": res["auc"], "val_acc": res["acc"],
        "examples_per_sec": len(losses) * gb / max(train_time, 1e-9),
        "num_hot": eng.num_hot,
        "epochs": epoch_records,
        "timing": timer.report(),
    }
    if lead:
        _dump_logs(args, report, losses)
    return report


def _train_assigned(args, cfg, model, rows, trn, device, eval_epoch,
                    maybe_ckpt, timer):
    """Assign-only mode of the JAX launcher (`cli.py:1070-1125`): the
    lookahead scheduler for S workers composes each global batch, the
    plain engine trains it (rank r the samples of assignment row r). Over
    S > 1 ranks rank 0 alone plans and every rank gets the assignments
    through a `BroadcastScheduler`. On `--resume` the scheduler pops the
    saved number of batches first on every rank (it is deterministic).
    Returns (engine, state, losses, overflow, stopped_early, report
    extras)."""
    from herald_tpu_torch.sched.scheduler import LookaheadScheduler
    from herald_tpu_torch.sched.service import BroadcastScheduler
    from herald_tpu_torch.train.checkpoint import load_checkpoint
    from herald_tpu_torch.train.engine import Engine
    eng = Engine(cfg, model=model, table_rows=rows, device=device)
    S = eng.num_shards
    gb = cfg.batch_size * S
    steps_per_epoch = len(trn[1]) // gb

    def make_sched():
        return LookaheadScheduler(
            trn[1], nrank=S, batch_size=cfg.batch_size,
            cache_size=cfg.cache_rows(rows), epochs=args.nepoch,
            top_k=cfg.sched_top_k_tables or 0, n_threads=cfg.sched_threads)
    sched = BroadcastScheduler(make_sched, eng.comm, cfg.batch_size) \
        if S > 1 else make_sched()
    try:
        done = 0
        if args.resume:
            state = load_checkpoint(args.resume, eng.device,
                                    padded_rows=eng.padded_rows,
                                    comm=eng.comm, tp=eng.tp_layout)
            _check_resumed(eng, state, args.resume)
            done = int(state.step)
            for _ in range(done):
                sched.pop()
        else:
            state = eng.init_state(cfg.seed)
        total = steps_per_epoch * args.nepoch
        target = min(total, args.max_steps) if args.max_steps else total
        cs = _ChunkStats()
        start_done = done
        while done < target:
            k = min(args.scan_steps, target - done,
                    steps_per_epoch - done % steps_per_epoch
                    if done % steps_per_epoch else steps_per_epoch)
            with timer:
                state, stats = eng.train_epoch_assigned(state, sched, *trn,
                                                        steps=k)
            if stats is None:
                break
            cs.push(stats)
            done += int(stats["loss"].shape[0])   # the executed count
            maybe_ckpt(eng, state, done, pre=lambda: (
                cs.drain(), _fail_on_overflow(cs.overflow)))
            if done % steps_per_epoch == 0 and done > start_done:
                cs.drain()
                lo = max(start_done, done - steps_per_epoch)
                eval_epoch(eng, state, done // steps_per_epoch - 1,
                           cs.losses[-(done - lo):])
        losses, overflow_total = cs.finish()
        _fail_on_overflow(overflow_total)
        extra = {"sched": {**sched.perf(),
                           "plan_time_us": sched.iter_time_us()}}
    finally:
        sched.close()
    return eng, state, losses, overflow_total, done < total, extra


def _preprocess_raw(args, spec, comm, lead: bool) -> None:
    """`--preprocess-raw`: the raw file into --data-path's six .npy files
    (JAX's `cli.py:613-619`). Over S ranks rank 0 writes them while the
    others wait at a barrier, then every rank loads them."""
    from herald_tpu_torch.data import (preprocess_avazu, preprocess_criteo,
                                       preprocess_criteo_search)
    pp = {"criteo": preprocess_criteo, "avazu": preprocess_avazu,
          "criteosearch": preprocess_criteo_search}.get(spec.name)
    if pp is None:
        raise ValueError(f"--preprocess-raw takes a criteo, avazu or "
                         f"criteosearch raw file; {args.model} reads "
                         f"{spec.name}")
    if not args.data_path:
        raise ValueError("--preprocess-raw requires --data-path")
    if lead:
        pp(args.preprocess_raw, args.data_path, seed=args.seed)
    if comm is not None:
        comm.barrier()


def _train_prefetched(args, eng, state, trn, spe, eval_epoch, maybe_ckpt,
                      timer):
    """The plain branch's epochs through a `DevicePrefetcher` (JAX's
    `cli.py:1143-1170`): chunks of `--scan-steps` steps staged ahead, an
    epoch's last chunk shorter (JAX drops those steps), a checkpoint at
    each `--ckpt-every` crossing and an eval per epoch. Losses and
    overflow stay on the device until a boundary needs them. Returns
    (state, losses, overflow)."""
    from herald_tpu_torch.data.prefetch import DevicePrefetcher
    pf = DevicePrefetcher(
        trn, steps_per_chunk=min(args.scan_steps, spe),
        global_batch=eng.cfg.batch_size * eng.num_shards,
        dtypes=(np.float32, np.int32, np.float32), device=eng.device,
        rank=eng.rank, ranks=eng.num_shards)
    cs = _ChunkStats()
    done = 0
    try:
        for chunk in pf(epochs=args.nepoch):
            with timer:
                state, stats = eng.train_epoch(state, chunk)
            cs.push(stats)
            done += chunk.steps
            maybe_ckpt(eng, state, done, pre=lambda: (
                cs.drain(), _fail_on_overflow(cs.overflow)))
            if done % spe == 0:
                cs.drain()
                eval_epoch(eng, state, done // spe - 1, cs.losses[-spe:])
    finally:
        pf.close()
    return (state, *cs.finish())


def _train_direct(args, eng, state, trn, spe, start_step, total_target,
                  eval_epoch, maybe_ckpt, timer):
    """The plain branch's chunks staged when they run (JAX's
    `cli.py:1171-1192`), from `start_step` to `total_target`: (state,
    losses, overflow)."""
    gb = eng.cfg.batch_size * eng.num_shards
    losses = []
    overflow_total = 0
    for ep in range(args.nepoch):
        done = max(0, min(start_step - ep * spe, spe))
        trained = 0
        while done < spe and ep * spe + done < total_target:
            k = min(args.scan_steps, spe - done,
                    total_target - ep * spe - done)
            lo = done * gb
            with timer:
                state, stats = eng.train_epoch(
                    state, trn[0][lo:], trn[1][lo:], trn[2][lo:], steps=k)
            losses.extend(stats["loss"].cpu().tolist())
            overflow_total += int(stats["overflow"].sum())
            done += k
            trained += k
            maybe_ckpt(eng, state, ep * spe + done)
        if done >= spe and trained:
            eval_epoch(eng, state, ep, losses[-trained:])
    return state, losses, overflow_total


def run_training(args) -> dict:
    import warnings

    from herald_tpu_torch.data import (dataset_for_model, frequency_remap,
                                       load_dataset)
    from herald_tpu_torch.models import get_model
    from herald_tpu_torch.parallel.comm import setup as setup_comm
    from herald_tpu_torch.train.checkpoint import (load_checkpoint,
                                                   save_checkpoint)
    from herald_tpu_torch.train.engine import Engine, resolve_device
    from herald_tpu_torch.utils.profiler import StepTimer, start_trace

    cfg = resolve_config(args)
    _refuse_unported(args, cfg)
    # no card: raise before any work
    comm = setup_comm(args.device) if cfg.comm_mode == "hybrid" else None
    device = comm.device if comm else resolve_device(args.device)
    lead = comm is None or comm.rank == 0     # the rank that writes
    if args.ckpt_serve_view and not args.scheduled:
        raise ValueError("--ckpt-serve-view only applies to --scheduled "
                         "runs (plain checkpoints already serve exactly)")
    if args.save_config and lead:
        parent = os.path.dirname(args.save_config)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(args.save_config, "w") as f:
            f.write(cfg.to_json())
    args.log_dir = args.log_dir or cfg.log_dir   # config-file fallback
    model = get_model(cfg.model)
    spec = dataset_for_model(cfg.model)
    if args.preprocess_raw:
        _preprocess_raw(args, spec, comm, lead)
    dense, sparse, labels = load_dataset(spec, args.data_path,
                                         num_samples=args.samples,
                                         seed=cfg.seed, num_rows=args.rows)
    rows = args.rows or int(sparse.max()) + 1
    if cfg.pinned_rows:
        # hottest ids -> [0, pinned_rows): the pinned tier's id contract
        sparse, _ = frequency_remap(sparse, rows)
    n_val = int(len(sparse) * args.val_ratio)
    val = (dense[-n_val:], sparse[-n_val:], labels[-n_val:])
    trn = (dense[:-n_val], sparse[:-n_val], labels[:-n_val])

    # per-epoch validation (reference run_laia.py:266-289): each record is
    # printed as it lands and collected into report["epochs"]
    epoch_records = []

    def eval_epoch(eng, state, ep, epoch_losses, approx=False, lut=None):
        with warnings.catch_warnings():
            if approx:
                # scheduled mode mid-stream: the table lacks the unflushed
                # cache deltas; the record says so instead of a warning
                warnings.simplefilter("ignore", UserWarning)
            r = (eng.evaluate_fae(state, lut, *val) if lut is not None
                 else eng.evaluate(state, *val))
        rec = {"epoch": ep,
               "train_loss": (float(np.mean(epoch_losses))
                              if len(epoch_losses) else None),
               "val_auc": r["auc"], "val_acc": r["acc"]}
        if approx:
            rec["val_approx_unsynced_cache"] = True
        epoch_records.append(rec)
        if lead:
            print(json.dumps({"epoch_eval": rec}), flush=True)

    timer = StepTimer()
    t_start = time.perf_counter()
    if _uses_fae(args, cfg):
        return _train_fae(args, cfg, rows, trn, val, device, eval_epoch,
                          epoch_records, timer, t_start, lead)
    last_ckpt = [0]
    ckpt_extras = [None]   # the scheduled branch installs the serve view

    def maybe_ckpt(eng, state, done, pre=None):
        # fire on CROSSING a multiple of ckpt_every: `done` advances in
        # chunk strides, so an exact-modulus test could miss a boundary
        fired = False
        if args.ckpt and args.ckpt_every \
                and done // args.ckpt_every > last_ckpt[0] // args.ckpt_every:
            if pre is not None:
                pre()
            save_checkpoint(
                state, args.ckpt,
                extras=ckpt_extras[0](state) if ckpt_extras[0] else None,
                comm=comm, tp=eng.tp_layout)
            last_ckpt[0] = done
            fired = True
        if args.crash_after and not args.resume \
                and done >= args.crash_after:
            # every rank ends here, at the same step
            if lead:
                print(json.dumps({"crashed_at": done}), flush=True)
            os._exit(17)
        return fired

    gb = cfg.batch_size
    prof = None
    if args.scheduled:
        prof = start_trace(device) if args.log_dir and lead else None
        eng, state, losses, overflow_total, stopped_early, extra = \
            _train_scheduled(args, cfg, rows, trn, device, comm,
                             eval_epoch, maybe_ckpt, ckpt_extras, timer)
        gb = cfg.batch_size * eng.num_shards     # the global batch
    elif args.assign_only:
        prof = start_trace(device) if args.log_dir and lead else None
        eng, state, losses, overflow_total, stopped_early, extra = \
            _train_assigned(args, cfg, model, rows, trn, device, eval_epoch,
                            maybe_ckpt, timer)
        gb = cfg.batch_size * eng.num_shards     # the global batch
    else:
        eng = Engine(cfg, model=model, table_rows=rows, device=device)
        prof = start_trace(device) if args.log_dir and lead else None
        gb = cfg.batch_size * eng.num_shards     # the global batch
        steps_per_epoch = len(trn[1]) // gb
        start_step = 0
        if args.resume:
            state = load_checkpoint(args.resume, eng.device,
                                    padded_rows=eng.padded_rows,
                                    comm=eng.comm, tp=eng.tp_layout)
            _check_resumed(eng, state, args.resume)
            start_step = int(state.step)   # skip already-trained batches
        else:
            state = eng.init_state(cfg.seed)
        total_target = args.nepoch * steps_per_epoch
        if args.max_steps:
            total_target = min(total_target, args.max_steps)
        if cfg.prefetch and start_step == 0 and not args.max_steps:
            # JAX's rule (cli.py:1140-1142): whole epochs from step 0
            state, losses, overflow_total = _train_prefetched(
                args, eng, state, trn, steps_per_epoch, eval_epoch,
                maybe_ckpt, timer)
        else:
            state, losses, overflow_total = _train_direct(
                args, eng, state, trn, steps_per_epoch, start_step,
                total_target, eval_epoch, maybe_ckpt, timer)
        _fail_on_overflow(overflow_total)
        stopped_early = total_target < args.nepoch * steps_per_epoch
        extra = {}

    train_time = time.perf_counter() - t_start
    if prof is not None:
        prof.stop()
        os.makedirs(args.log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.log_dir, "trace.json"))
    # an early-stopped scheduled run holds unflushed deltas (resumable
    # state, not an evaluable one): it skips the final eval, as in JAX
    res = {"auc": None, "acc": None} if (args.scheduled and stopped_early) \
        else eng.evaluate(state, *val)
    if args.ckpt:
        save_checkpoint(
            state, args.ckpt,
            extras=ckpt_extras[0](state) if ckpt_extras[0] else None,
            comm=comm, tp=eng.tp_layout)
    if args.export_onnx:
        # the serving handoff (JAX: cli.py:1208-1217); a scheduled state is
        # synced above unless the run stopped early with unflushed deltas.
        # Over S ranks every rank enters, rank 0 writes the file
        if args.scheduled and (stopped_early
                               or getattr(eng, "_unsynced", False)):
            raise SystemExit("--export-onnx needs a fully-synced state; "
                             "finish the run (no early stop) first")
        from herald_tpu_torch.onnx import export_state
        export_state(eng, state, args.export_onnx)
        if lead:
            print(f"exported ONNX model to {args.export_onnx}", flush=True)

    report = {
        "model": cfg.model,
        "mode": ("scheduled" if args.scheduled
                 else "assigned" if args.assign_only else "baseline"),
        "comm": cfg.comm_mode,
        "devices": eng.num_shards,
        # a hybrid run names its process group's backend (None: one rank
        # without a group)
        **({"backend": comm.backend} if comm else {}),
        "device": str(eng.device),
        "steps": len(losses),
        "stopped_early": stopped_early,
        "overflow_rows": overflow_total,
        "train_loss_last": float(np.mean(losses[-20:])) if losses else None,
        "val_auc": res["auc"],
        "val_acc": res["acc"],
        "examples_per_sec": len(losses) * gb / max(train_time, 1e-9),
        "epochs": epoch_records,
        "timing": timer.report(),
        **extra,
    }
    if lead:
        _dump_logs(args, report, losses)
    return report


def main(argv=None):
    args = build_parser().parse_args(argv)
    report = run_training(args)
    # over several ranks every rank returns the report; rank 0 prints it
    import torch.distributed as dist
    if not (dist.is_initialized() and dist.get_rank() > 0):
        print(json.dumps(report, indent=2, default=float))
    if dist.is_initialized():
        # leave the group together, before the interpreter's exit tears
        # gloo's connections down under a rank still in it
        dist.barrier()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
