"""Training launcher (port of `herald_tpu/launch/cli.py`).

    python -m herald_tpu_torch.launch --model wdl_criteo --bf16-table \
        --nepoch 1 --batch-size 256 --embedding-size 128 [--device cuda|cpu]

The flags are herald_tpu.launch's, plus `--device`. The port runs the plain
local trainer (the launcher's default branch, `cli.py:1126-1238`): init or
`--resume`, chunks of `--scan-steps` steps through `Engine.train_epoch`,
checkpoints at `--ckpt-every` crossings and at the end, `--max-steps`,
a validation pass per finished epoch and at the end, and the same report.
It always stages each chunk from the host in one copy, whatever
`--no-prefetch` says (the async prefetcher is a later item). The other
modes and options raise NotImplementedError naming their ROADMAP item;
none is ignored.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

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
                   help="multi-host run (not ported: raises)")
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
                        "+ staged to device AHEAD of the training loop "
                        "(a pop thread + small staging pool). 0 disables "
                        "(per-chunk depth-1 staging). 'all' stages the "
                        "ENTIRE stream to HBM before the first dispatch "
                        "— the timed loop is then pure dispatch, which "
                        "is the device-ceiling mode on transports where "
                        "transfers serialize with compute (budget: "
                        "~wire-bytes-per-step x total steps of HBM; "
                        "pair with --plan-cache + --device-data). "
                        "Exactness is untouched in every mode: the "
                        "chunk stream is identical and serve-view "
                        "residency mirrors advance at dispatch time")
    p.add_argument("--prestage-threads", type=int, default=2,
                   help="staging pool width for --prestage (parallel "
                        "device_puts; raise if staging wall time still "
                        "exceeds device execution per chunk)")
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
    ("scheduled", "--scheduled", "item 3 (scheduled engine, slice 3)"),
    ("assign_only", "--assign-only", "item 8 (scheduled engine, "
     "multi-rank: train_epoch_assigned)"),
    ("fae", "--fae", "item 11 (FAE engine)"),
    ("export_onnx", "--export-onnx", "item 12 (ONNX)"),
    ("multihost", "--multihost", "items 7-9 (multi-rank engines and "
     "checkpoints)"),
    ("preprocess_raw", "--preprocess-raw", "item 10 (launcher and input "
     "feed: data/preprocess.py)"),
    ("int8_flush", "--int8-flush", "item 3 (scheduled engine: the int8 "
     "flush wire)"),
    ("platform", "--platform", "none: it is JAX's platform switch; use "
     "--device"),
)


def _refuse_unported(args, cfg) -> None:
    for attr, flag, item in _NOT_PORTED:
        if getattr(args, attr):
            raise NotImplementedError(
                f"{flag} is not ported to herald_tpu_torch yet "
                f"(ROADMAP queue 1, {item})")
    if cfg.mp_shards > 1:
        raise NotImplementedError(
            "--mp-shards > 1 is not ported to herald_tpu_torch yet "
            "(ROADMAP queue 1, item 13: tensor parallel)")
    if cfg.comm_mode != "local":
        raise NotImplementedError(
            f"--comm {cfg.comm_mode} is not ported to herald_tpu_torch yet "
            f"(ROADMAP queue 1, item 7: hybrid exchange)")
    if cfg.use_scheduler or cfg.use_cache:
        raise NotImplementedError(
            "a config with use_scheduler/use_cache is not ported to "
            "herald_tpu_torch yet (ROADMAP queue 1, item 3)")


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


def _start_trace(eng):
    """A torch.profiler session over the training loop (the JAX
    launcher's jax.profiler trace)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if eng.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _check_resumed(eng, state, path) -> None:
    """A checkpoint must fit the engine it resumes: table shape and dtype,
    and the optimizers' slots."""
    want = (eng.padded_rows, eng.width)
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


def run_training(args) -> dict:
    from herald_tpu_torch.data import dataset_for_model, load_dataset
    from herald_tpu_torch.models import get_model
    from herald_tpu_torch.train.checkpoint import (load_checkpoint,
                                                   save_checkpoint)
    from herald_tpu_torch.train.engine import Engine, resolve_device
    from herald_tpu_torch.utils.profiler import StepTimer

    cfg = resolve_config(args)
    _refuse_unported(args, cfg)
    device = resolve_device(args.device)   # no card: raise before any work
    if args.ckpt_serve_view:
        raise ValueError("--ckpt-serve-view only applies to --scheduled "
                         "runs (plain checkpoints already serve exactly)")
    if args.save_config:
        parent = os.path.dirname(args.save_config)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(args.save_config, "w") as f:
            f.write(cfg.to_json())
    args.log_dir = args.log_dir or cfg.log_dir   # config-file fallback
    model = get_model(cfg.model)
    spec = dataset_for_model(cfg.model)
    dense, sparse, labels = load_dataset(spec, args.data_path,
                                         num_samples=args.samples,
                                         seed=cfg.seed, num_rows=args.rows)
    rows = args.rows or int(sparse.max()) + 1
    n_val = int(len(sparse) * args.val_ratio)
    val = (dense[-n_val:], sparse[-n_val:], labels[-n_val:])
    trn = (dense[:-n_val], sparse[:-n_val], labels[:-n_val])

    # per-epoch validation (reference run_laia.py:266-289): each record is
    # printed as it lands and collected into report["epochs"]
    epoch_records = []

    def eval_epoch(eng, state, ep, epoch_losses):
        r = eng.evaluate(state, *val)
        rec = {"epoch": ep,
               "train_loss": (float(np.mean(epoch_losses))
                              if len(epoch_losses) else None),
               "val_auc": r["auc"], "val_acc": r["acc"]}
        epoch_records.append(rec)
        print(json.dumps({"epoch_eval": rec}), flush=True)

    eng = Engine(cfg, model=model, table_rows=rows, device=device)
    timer = StepTimer()
    t_start = time.perf_counter()
    prof = _start_trace(eng) if args.log_dir else None

    last_ckpt = [0]

    def maybe_ckpt(state, done):
        # fire on CROSSING a multiple of ckpt_every: `done` advances in
        # chunk strides, so an exact-modulus test could miss a boundary
        if args.ckpt and args.ckpt_every \
                and done // args.ckpt_every > last_ckpt[0] // args.ckpt_every:
            save_checkpoint(state, args.ckpt)
            last_ckpt[0] = done
        if args.crash_after and not args.resume \
                and done >= args.crash_after:
            print(json.dumps({"crashed_at": done}), flush=True)
            os._exit(17)

    gb = cfg.batch_size
    steps_per_epoch = len(trn[1]) // gb
    start_step = 0
    if args.resume:
        state = load_checkpoint(args.resume, eng.device,
                                padded_rows=eng.padded_rows)
        _check_resumed(eng, state, args.resume)
        start_step = int(state.step)   # skip already-trained batches
    else:
        state = eng.init_state(cfg.seed)
    losses = []
    overflow_total = 0
    total_target = args.nepoch * steps_per_epoch
    if args.max_steps:
        total_target = min(total_target, args.max_steps)
    for ep in range(args.nepoch):
        done = max(0, min(start_step - ep * steps_per_epoch,
                          steps_per_epoch))
        trained = 0
        while done < steps_per_epoch \
                and ep * steps_per_epoch + done < total_target:
            k = min(args.scan_steps, steps_per_epoch - done,
                    total_target - ep * steps_per_epoch - done)
            lo = done * gb
            with timer:
                state, stats = eng.train_epoch(
                    state, trn[0][lo:], trn[1][lo:], trn[2][lo:], steps=k)
            losses.extend(stats["loss"].cpu().tolist())
            overflow_total += int(stats["overflow"].sum())
            done += k
            trained += k
            maybe_ckpt(state, ep * steps_per_epoch + done)
        if done >= steps_per_epoch and trained:
            eval_epoch(eng, state, ep, losses[-trained:])
    stopped_early = total_target < args.nepoch * steps_per_epoch

    train_time = time.perf_counter() - t_start
    if prof is not None:
        prof.stop()
        os.makedirs(args.log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.log_dir, "trace.json"))
    res = eng.evaluate(state, *val)
    if args.ckpt:
        save_checkpoint(state, args.ckpt)

    report = {
        "model": cfg.model,
        "mode": "baseline",
        "comm": cfg.comm_mode,
        "devices": 1,
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
    }
    _dump_logs(args, report, losses)
    return report


def main(argv=None):
    args = build_parser().parse_args(argv)
    report = run_training(args)
    print(json.dumps(report, indent=2, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
