#!/usr/bin/env python3
"""Drive herald_tpu_torch on one NVIDIA card (H100): build its CUDA kernels
and its host planner and scheduler from the sources in this checkout, hold
each kernel against its plain PyTorch version, serve and train wdl_criteo
at full width, plainly, in assign-only mode, through the FAE engine and
through the scheduled, cached engine, over ranks with the tensor-parallel
tower, train the distributed GCN and the pipelines, search layouts, and
print what it measured.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase scheduled|scheduled:pinned|train|fae \
        [--root DIR]
    python3 chip_smoke.py --phase assigned|hybrid
    python3 chip_smoke.py --phase feed [--root DIR]
    python3 chip_smoke.py --phase onnx
    python3 chip_smoke.py --phase gnn
    python3 chip_smoke.py --phase tp
    python3 chip_smoke.py --phase unique
    python3 chip_smoke.py --phase pool

Prints one JSON object per line (a phase's with "elapsed_s", the
seconds since the script started), in this order: device, build,
kernel:embedding_gather, kernel:hot_onehot_push, kernel:unique_fill,
kernel:rows_scatter_add, serve, checkpoint, train, assigned, onnx,
kernel:gather_pool_rows, train:dlrm, train:adam, launch, launch:assigned,
fae, launch:fae, scheduled, scheduled:memo, scheduled:pinned,
kernel:hot_onehot_gather, launch:scheduled, launch:feed, hybrid,
hybrid:checkpoint,
hybrid:assigned, hybrid:fae, hybrid:scheduled, launch:hybrid, gnn,
hybrid:tp:2, hybrid:tp:4, the audit table, autoshard, pipeline,
launch:tp, kernel:fm_second_order,
kernel:dfm_width, serve:dfm, train:dfm, onnx:dfm, launch:dfm,
scheduled:dfm, the
kernels summary, profiler (the torch.profiler sessions taken and those
that lost kernel records), the card's name and power limit, and last
{"ok": true, "device": {...}}.
Every phase that fails raises: the script then exits non-zero and prints
no "ok" line. It needs a CUDA card, nvcc (CUDA_HOME or /usr/local/cuda),
g++ and this checkout; it uses no network beyond 127.0.0.1.

Full width is the shape of bench.py: batch 256, embedding 128, the
33,762,577-row Criteo table (padded to 33,762,584) in bfloat16, 8.64 GB,
with random weights from a seed; training is bench_engine's SGD at
lr 0.01 on batches of synthetic_ctr_data(seed=0). The scheduled phases
run bench_scheduled's configuration: the same table and data (256
batches), a cache of 10% of the rows (3,376,257 x 256 f32, 3.46 GB) and
program widths sized from a host probe pass.

assigned trains the same table in assign-only mode (the lookahead
scheduler for one worker composes each batch; 8 steps against the plain
steps over the same samples, then both timed in turns), and
launch:assigned runs `--assign-only` at full width and a stop/resume
pair at 4,096 rows that must be bit-exact. fae runs the FAE engine on
fae_wdl_criteo at the same width (a hot block of 1% of the rows, 337,625
x 128 bf16; the cold read by position through K1, the hot read through
K4's add form, K3 for the cold and the hot gradient sums): 8 steps
against the plain versions of K1, K3 and K4, 64 timed steps with their
launches and no plain-version call, host waits, a step profile, the
dense hot update's device time and evaluate_fae; launch:fae runs the
launcher's FAE branch at full width.

kernel:gather_pool_rows holds K1's pooled form to its plain version, and
at DLRM-DCNv2's step (batch 8,192, 214 ids a sample) over the benchmark
cell's 124,184,588 x 128 f32 table (63.58 GB) checks and times it;
train:dlrm trains DLRM-DCNv2 at its published widths through train_epoch
and scores through predict and evaluate, its launches counted.

hybrid trains the same table row-sharded over two ranks that share this
card (gloo: NCCL refuses two ranks on one device), each a process of
its own started by this script (`--hybrid-rank`): 16,881,296 rows a
rank, global batches of 512, SGD at lr 0.01. 8 steps are held against
the one-device engine over the same global batches from one logical
state and against the same steps through the plain versions of K1 and
K3; 64 steps are timed, rank 0 profiles a chunk of 8 and times K1's four
and K3's two sites of the step at their shapes. That rate measures gloo
on one card, not the exchange over several cards. The same two rank
processes then run hybrid:checkpoint (each saves its 4.32 GB block of
the plain state into its own shard file under the build directory, rank
0 the tower and the manifest, and restores it into fresh tensors; the
restore equal to what was saved, 4 steps from each bit-identical in
losses and the table's row fingerprints, their launches counted and
rank 0's profiled; each rank's bytes, save and load seconds and GB/s
printed, the files deleted), hybrid:assigned (assign-only mode: rank
0's lookahead scheduler for two workers, its assignments broadcast by a
BroadcastScheduler; 8 steps against the plain steps over the same global
batch sets, each rank's ids its row of the assignment, then both timed
in turns) and hybrid:fae (fae_wdl_criteo: the cold table row-sharded,
the 337,625 x 128 hot block replicated and its gradient all-reduced; 8
steps against the one-device FaeEngine and against the plain versions
of K1, K3 and K4's add form, the hot block bit-identical on both ranks,
16 timed steps with the hot all-reduce's host ms, rank 0's profile and
the step's eight kernel sites timed) and hybrid:scheduled (the cached
engine over the ranks). launch:hybrid runs `torch.distributed.run` with
2 ranks on card 0 (gloo), plainly, with `--model fae_wdl_criteo`, with
`--assign-only` and with `--scheduled`, and with 1 rank (NCCL), the
latter's losses equal to the local launcher's; then, at 65,536 rows,
the plain, assign-only and scheduled branches with 2 ranks stopped at
step 8 with --ckpt and resumed with --resume, bit for bit the
uninterrupted runs, 1 rank resuming the 2-rank plain checkpoint, and
the supervisor (`herald_tpu_torch.launch.supervise`) recovering a
1-rank scheduled run that crashes at step 6 to the uninterrupted run's
report.

launch:feed runs the launcher's input feed at full width: a raw
Criteo-layout TSV of 400,000 lines (over 64 MB, so the native parser
runs) preprocessed in this process (MB/s) and by `--preprocess-raw` (the
same six files); on the processed files the plain launcher with its
prefetcher and with `--no-prefetch` (2 epochs in chunks of 32, which do
not divide an epoch's steps) and the scheduled launcher
(`--pinned-rows 4096 --plan-cache --device-data`, 2 epochs) at
`--prestage 0`, `3` and `all`, each run twice in this process, the
second time profiled: reports and final states equal (the states
compared in device memory), the idle share and the copies' streams of
every mode, the pinned host memory of every run; and 2-rank pairs on
card 0 at 65,536 rows (`--scheduled --prestage 3` against `0`, the
prefetched plain run against `--no-prefetch`), exact. It prints the
predicted rates beside the measured ones.

onnx exports the trained full-width wdl state with
`herald_tpu_torch.onnx.export_state` (its whole table, a 17.3 GB f32
file) after 8 more steps, loads the file with `OnnxModel` (mapped, not
read) and scores 2 held-out batches as Engine.predict does (rtol 1e-4,
atol 1e-6, tests/test_onnx.py's), printing the file's bytes, export_s,
load_s, the scoring ms, the free disk before the export and the host's
MemAvailable; onnx:dfm does the same for the trained dfm state over the
first 1,048,576 rows of its table (the whole f32 table would be 69 GB),
and launch:hybrid adds `--export-onnx` to its 2-rank plain and 1-rank
scheduled launches at 65,536 rows, each file scored against the run's
final checkpoint.

gnn trains the distributed GCN (herald_tpu_torch/gnn/) at the shape of
benchmarks/gnn_ab.py:51-70: synthetic_sbm(20,000 nodes, 8 classes, 64
features, mean degree 16 at 4:1 in:out, seed 1), GCNConfig(64, 64, 8),
lr 0.5, in the cases broadcast, pull, halo and halo_reorder (relabeled by
locality_reorder for 2 ranks). At one rank in this process: the first
logits, 20 SGD steps and the final parameters against the same model with
K1 and K3 swapped for their plain versions on the card, and the first
logits against a float64 scipy.sparse forward (1e-4); 60 epochs in halo
mode beat the feature-only least-squares probe by 0.05 (the same edges,
features at noise 4.0: at 0.6 the probe already scores 1.0). At two ranks
sharing this card over gloo, each a process of its own started by this
script (`--gnn-rank`): the same runs against the one-rank ones and
against the plain versions of K1 and K3 there (1e-5 of the largest
magnitude; halo's exchange launches K1 and K3 only over ranks), overflow
0, the launches a step, and the collective bytes of a step by kind, with
halo's and halo_reorder's reduction against broadcast. Then
host ms and device busy a step at one rank, the launches a step of each
mode, and K1 and K3 timed at every site of the halo step and at the pull
step's exchange sites, forward and backward.

The dfm phases run DeepFM at the repo's own dfm_criteo configuration of
batch 1024, embedding 512 (BASELINE.md:26-27) over the same full table,
fused to 513 columns (34.64 GB in bfloat16): K5 (fm_second_order, forward
and backward) against its plain versions, K1 and K2 timed at width 513
(K3 is timed at dfm's shape in its own phase, before the dfm table
exists), serving, SGD training at lr
0.01 (8 steps held against the plain versions of K1, K2, K3 and K5), the
launcher, and the scheduled engine with a 10% cache (13.86 GB).

K1 is held bit for bit against its plain version in the table's dtype and
widened to f32 (513-wide odd rows, int32 and int64 ids, 10% out of range
included), and timed at both widths by position with f32 output, the
main path's read, beside the route it replaced (K1 on the unique ids,
`[inv]`, widen) and `index_select` + widen. K2 is held against its plain
version on `-lr * grads` and timed with lr beside the route it replaced
(`-lr * g`, then K2). Both record where their wrapper's host time goes.
K4 is held bit for bit in both forms, the gather and the in-place add
the pinned step runs (into contiguous and strided f32 rows, -0.0 in cold
rows), and timed at the pinned step's shape beside the route the add
replaced (gather, widen, add) and at FAE's shape. The serve phases count
the eval step's waits for the card (none); scheduled:pinned profiles its
step.

Every step of every path runs as a CUDA graph (`herald_tpu_torch/train/
graphs.py`). Besides the gates above: captured steps are held bit for bit
against the same engine built with `cuda_graphs=False`, from one state
(train and train:dfm on a compact copy of the rows their steps touch,
train:adam, fae, serve and serve:dfm, and scheduled:pinned on a stream
that flushes every step); the host waits for the card 0 times a step on
train, train:adam, fae, scheduled (tape and live), scheduled:pinned, the
eval step and train:dfm; launches are counted as before, a graph adding
its capture's launches on each replay; and each path's device busy a
step stays within 5% of what this script measured before the steps ran
as CUDA graphs (`RUN_B_BUSY_MS`).

scheduled:memo runs the live planner of scheduled on its stream, first
with the staged-chunk memo off alone, then off and on, two engines from
one seed, their epochs in turns in one process: each epoch's host time
split into the planner's pop, `_chunk_program`, the pack into pinned
memory, the copy's issue, the memo's hits and misses and the steps'
dispatch, its hits and its rate beside `MEMO_PREDICTED`; 0 host waits a
step, device busy and the HtoD copies a step from one profiled chunk of
each; the runs bit-identical (losses, and every leaf of the synced state
of memo on and off).

`--phase scheduled` (scheduled and scheduled:memo), `--phase
scheduled:pinned`, `--phase train` (train alone), `--phase fae` and
`--phase unique` (the dedup's kernel against the library chain) run
the device and build phases and that phase alone; `--phase fae`
and `--phase assigned` also run launch:fae or launch:assigned,
`--phase hybrid` runs hybrid and launch:hybrid, and `--phase feed` runs
launch:feed on `--samples` data of the same size instead of the raw
file, so that a parent tree without the preprocessor runs the same
launches; `--phase onnx` runs onnx and onnx:dfm, each from a fresh
full-width engine; `--phase gnn` runs gnn; `--phase tp` runs
hybrid:tp, autoshard, pipeline and launch:tp (`phase_tp`,
`phase_launch_tp`: wdl_criteo's tensor-parallel tower at full width over
(dp, mp) = (1, 2) and (2, 2) ranks sharing the card over gloo, each
held to the one-device engine and to the plain K1 and K3; the layout
search over 4 ranks at a cut table; GPipe, 1F1B and HetPipe over (dp,
pp) = (2, 2) against their one-device oracles; the launcher with
`--mp-shards 2`, its checkpoint resumed at mp = 1, and its ONNX export).
Their times measure gloo between processes on one card, not NVLink. `--root
DIR` imports herald_tpu_torch from another checkout, so that the steps
of two trees (a parent unpacked with `git archive` into a gitignored
directory, and this one) are timed and profiled in turns on one card,
each run a process of its own; a tree without CUDA graphs runs the
phase without the gates that need them:

    for r in PARENT . . PARENT; do
        python3 chip_smoke.py --phase train --root $r
        python3 chip_smoke.py --phase fae --root $r; done
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import importlib.util
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import warnings
from pathlib import Path

import numpy as np
import torch

if "--root" in sys.argv:        # the package of another checkout
    sys.path.insert(0, str(Path(
        sys.argv[sys.argv.index("--root") + 1]).resolve()))

import herald_tpu_torch
from herald_tpu_torch.config import HeraldConfig
from herald_tpu_torch.data import (DATASETS, frequency_remap,
                                   synthetic_ctr_data)
from herald_tpu_torch.models import bce_with_logits, get_model
from herald_tpu_torch.models.base import mlp_apply
from herald_tpu_torch.ops.kernels import (KERNELS, build, embedding_gather,
                                          embedding_gather_ref,
                                          fm_second_order,
                                          fm_second_order_backward,
                                          fm_second_order_bwd_ref,
                                          fm_second_order_ref,
                                          hot_onehot_gather,
                                          hot_onehot_gather_ref,
                                          hot_onehot_push,
                                          hot_onehot_push_ref,
                                          rows_scatter_add,
                                          rows_scatter_add_ref)
from herald_tpu_torch.ops.kernels.gather import _launcher as gather_launcher
from herald_tpu_torch.ops.kernels.gather import check_gather_args
# K4's add form through its module: a checkout from before it (an A/B's
# parent under --root) imports and runs scheduled:pinned all the same
from herald_tpu_torch.ops.kernels import fm as k5_ops
from herald_tpu_torch.ops.kernels import gather as k1_ops
from herald_tpu_torch.ops.kernels import hot_gather as k4_ops
from herald_tpu_torch.ops.kernels import scatter as k2_ops
from herald_tpu_torch.ops.kernels import segment as k3_ops
from herald_tpu_torch.ops import embedding as embedding_ops
from herald_tpu_torch.ops.kernels.scatter import _launcher as scatter_launcher
from herald_tpu_torch.ops.kernels.scatter import check_scatter_args
from herald_tpu_torch.sched import build as host_build
from herald_tpu_torch.sched.build import planner_lib_path
from herald_tpu_torch.sched.replay import ReplayPlanner, plan_cache
from herald_tpu_torch.sched.sizing import (TrafficProfile,
                                           profile_planned_traffic)
from herald_tpu_torch.serve import Scorer, load_scorer, make_server
from herald_tpu_torch.train.cached import CachedEngine
from herald_tpu_torch.train.checkpoint import (load_cached_checkpoint,
                                               load_checkpoint, load_extra,
                                               save_checkpoint)
from herald_tpu_torch.train.engine import Engine, TrainState
from herald_tpu_torch.utils.profiler import cache_report

ROOT = Path(__file__).resolve().parent
# the dedup's kernel: a checkout from before it (an A/B's parent under
# --root) has no such module, and its phases run without it
unique_ops = (importlib.import_module("herald_tpu_torch.ops.kernels.unique")
              if importlib.util.find_spec(
                  "herald_tpu_torch.ops.kernels.unique") else None)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory, published peak
# the imported tree runs its steps as CUDA graphs (a parent under --root
# may not): the gates that need them run only then
GRAPHS = importlib.util.find_spec("herald_tpu_torch.train.graphs") \
    is not None
# device busy ms a scored batch or a step as this script measured it
# before the steps ran as CUDA graphs (PERF.md, run B; NVIDIA H100 80GB
# HBM3, 700 W): the graphs launch the same kernels, so each path stays
# within BUSY_GATE of it
RUN_B_BUSY_MS = {"serve": 0.03789, "train": 0.19366, "fae": 0.89933,
                 "scheduled": 0.17490, "scheduled:pinned": 0.19502,
                 "serve:dfm": 0.28610, "train:dfm": 1.09368,
                 "scheduled:dfm": 1.32297}
BUSY_GATE = 1.05
FULL_ROWS = DATASETS["criteo"].num_embed_rows      # 33,762,577
BATCH, EMB = 256, 128


# a phase line's "elapsed_s": seconds since the script started
STARTED = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - STARTED}
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, calls: int, repeats: int = 7, warmup: int = 3) -> float:
    """Median over `repeats` of the device time of `calls` calls of
    fn(i), per call, from CUDA events."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(calls):
            fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


# the calls that launch a kernel, as the profiler names them on the host:
# the CUDA runtime API's and the lower-level cu* API's, and a graph's
# replay (its kernels carry the replay's correlation id)
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")
# kernels each profiler session launches before the measured calls: a
# spin of one cycle each (`torch.cuda._sleep`). From some point in a long
# process on, a session loses the device records of its first launches
# (mostly 6 to 11, at times some tens: past 32 in sessions of a run of
# the whole script on an H100), however long the session and whether or
# not it first idles. These launches take that loss; their own kernel is
# left out of the session's items, and a session that lost more is
# retaken where its calls can run again
PAD_LAUNCHES, PAD_KERNEL = 256, "spin_kernel"
SPAN_PREFIX = "herald."
# the sessions taken; how many lost records of pad launches alone; and
# each that lost a measured launch's record, with the positions it lost
PROFILER = {"sessions": 0, "lost_in_pad": 0, "short": []}


def _device_items(prof, calls: int):
    """From a profiler session: ({kernel or copy name: device ms per
    call}, {name: count}), the pad's kernel and the program's span
    annotations (`herald.<name>`, `utils/profiler.py`, which the profiler
    also lays on the card's timeline) left out."""
    from torch.autograd import DeviceType
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0 and PAD_KERNEL not in e.key
              and not e.key.startswith(SPAN_PREFIX)]
    return ({e.key: e.self_device_time_total / 1e3 / calls for e in events},
            {e.key: e.count for e in events})


def _session(fn, n: int, pad: int = PAD_LAUNCHES):
    """One torch.profiler session: `pad` pad launches, then fn(0), ...,
    fn(n - 1). Returns the session, host ms per call from the first
    measured launch to the end of the last kernel, and the positions of
    the measured launches whose kernel left no device record (launch and
    kernel matched by correlation id in the session's trace; the pad's
    positions are 0 to pad - 1)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(pad):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    recorded = {e.get("args", {}).get("correlation") for e in events
                if e.get("cat") == "kernel"}
    order, seen = [], set()
    for e in sorted((e for e in events if e.get("name") in LAUNCH_APIS
                     and e.get("ph") == "X"), key=lambda e: e["ts"]):
        corr = e.get("args", {}).get("correlation")
        if corr not in seen:        # a launch may show under both APIs
            seen.add(corr)
            order.append(corr)
    lost = [i for i, corr in enumerate(order) if corr not in recorded]
    PROFILER["sessions"] += 1
    measured = [i for i in lost if i >= pad]
    if measured:
        PROFILER["short"].append({
            "session": PROFILER["sessions"], "pad": pad,
            "launches": len(order), "lost": len(lost),
            "lost_at": lost if len(lost) <= 16 else lost[:8] + lost[-8:]})
    elif lost:
        PROFILER["lost_in_pad"] += 1
    return prof, host_ms, measured


def device_profile(fn, calls: int, marker: str = None,
                   pad: int = PAD_LAUNCHES, tries: int = 3):
    """Device time per call of fn(i), from torch.profiler's CUDA activity:
    (total ms, {kernel or copy name: ms}, host ms per call while
    profiled, {sessions taken, measured launches the last one lost}). A
    session is taken again, up to `tries` in all, while it saw no device
    activity, lost the record of a measured launch, or recorded fewer
    than `calls` of the kernels whose name holds `marker` (one a call).
    Where none passed, the total is None and the items are empty:
    nothing is scaled or filled in."""
    fn(0)
    torch.cuda.synchronize()
    for n_try in range(1, tries + 1):
        prof, host_ms, lost = _session(fn, calls, pad)
        per, counts = _device_items(prof, calls)
        own = sum(c for k, c in counts.items() if marker and marker in k)
        check = {"sessions": n_try, "lost": len(lost)}
        if per and not lost and (marker is None or own >= calls):
            return sum(per.values()), per, host_ms, check
    return None, {}, host_ms, check


# ----------------------------------------------------------------------
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi


def phase_build() -> None:
    """Every kernel (one nvcc each, all at once) while g++ builds the
    planner."""
    t0 = time.perf_counter()
    planner = {}

    def build_planner():
        t = time.perf_counter()
        planner["path"] = planner_lib_path()
        planner["seconds"] = time.perf_counter() - t

    def build_sched():
        # the lookahead scheduler; a checkout from before assign-only mode
        # (an A/B's parent under --root) has no such library
        if hasattr(host_build, "sched_lib_path"):
            planner["sched"] = Path(host_build.sched_lib_path()).name

    threads = [threading.Thread(target=f)
               for f in (build_planner, build_sched)]
    for thread in threads:
        thread.start()
    logs = build.build_all()
    kernels_s = time.perf_counter() - t0
    for thread in threads:
        thread.join()
    if "path" not in planner or ("sched" not in planner and hasattr(
            host_build, "sched_lib_path")):
        raise AssertionError("the planner or the scheduler did not build")
    seconds = time.perf_counter() - t0
    # per kernel source, from nvcc -Xptxas=-v: the most registers any of
    # its instantiations uses, and whether any spills to local memory
    ptxas = {name: {"max_registers": max(
                        map(int, re.findall(r"Used (\d+) registers", log)),
                        default=None),
                    "spills": bool(re.search(r"[1-9]\d* bytes spill", log))}
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": seconds, "kernels_s": kernels_s,
          "built": sorted(logs), "ptxas": ptxas,
          "planner": Path(planner["path"]).name,
          "planner_s": planner["seconds"],
          "scheduler": planner.get("sched")})


def _gather_cases():
    """(label, table, ids, out_dtype) cases on the card: ids as int32 and
    int64, output in the table's dtype and in f32."""
    g = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    for dt in (torch.float32, torch.bfloat16):
        for R, D, N, oob, odd in ((512, 128, 60, 0.0, False),  # pallas test
                                  (1001, 13, 300, 0.1, False),  # R % 8, tail
                                  (100_000, 128, 6656, 0.1, False),
                                  (100_000, 513, 13_000, 0.1, False),  # dfm
                                  # odd rows of 513: no row 16-byte aligned
                                  (100_000, 513, 13_000, 0.1, True),
                                  (512, 128, 0, 0.0, False)):
            table = torch.randn((R, D), generator=g, device="cuda").to(dt)
            ids = rng.integers(0, R, N)
            if odd:
                ids |= 1
            bad = rng.random(N) < oob
            ids[bad] = np.where(rng.random(bad.sum()) < 0.5,
                                -rng.integers(1, 10 * R, bad.sum()),
                                R + rng.integers(0, 10 * R, bad.sum()))
            for idt in (torch.int32, torch.int64):
                for out in (None, torch.float32):
                    label = (f"{str(dt)[6:]} R={R} D={D} N={N}"
                             f"{' odd ids' if odd else ''} {str(idt)[6:]}"
                             f" -> {str(out or dt)[6:]}")
                    yield label, table, torch.as_tensor(
                        ids, dtype=idt, device="cuda"), out


def phase_kernel(table: torch.Tensor, batches, positions, inverses
                 ) -> dict:
    """K1 against its plain version, bit-exact, in the table's dtype and
    widened to f32; a dtype it does not write raises. Then timed at the
    serving shape on the full table: by position with f32 output (the main
    path: each launch on the 6,656 ids of another 256-batch) beside the
    route it replaced and the library route, and on the unique ids of each
    batch in bf16 (the read before rows were read by position)."""
    cases, worst = [], 0.0
    for label, tab, ids, od in list(_gather_cases()) + [
            ("serving bf16 full table, batch 0 unique ids", table,
             batches[0], None),
            ("serving bf16 full table, batch 0 positions -> f32", table,
             positions[0], torch.float32)]:
        got = embedding_gather(tab, ids, od)
        want = embedding_gather_ref(tab, ids, od)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max()) \
            if got.numel() else 0.0
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"embedding_gather differs from its "
                                 f"plain version ({label}): max {err}")
        worst = max(worst, err)
        cases.append(label)
    refused = _refusals(lambda: embedding_gather(
        table[:8].float(), batches[0][:4], torch.bfloat16))
    out = {"name": "embedding_gather", "cases": len(cases),
           "max_abs_err": worst, "refused_other_out_dtype": refused,
           **_position_timing(table, positions, batches, inverses),
           "unique_ids": _gather_timing(table, batches),
           "wrapper_host_us": _wrapper_host_us(
               lambda: embedding_gather(table, positions[0], torch.float32),
               _gather_entry(table, positions[0]),
               lambda: torch.index_select(table, 0, positions[0]),
               lambda: check_gather_args("embedding_gather", table,
                                         positions[0]),
               lambda: torch.empty((positions[0].numel(), table.shape[1]),
                                   dtype=torch.float32, device="cuda"))}
    emit({"phase": "kernel:embedding_gather", **out})
    return out


def _refusals(*calls) -> int:
    """How many of the calls raise ValueError; fails unless all do (a
    wrapper never falls back to its plain version or the CPU)."""
    for call in calls:
        try:
            call()
        except ValueError:
            continue
        raise AssertionError("a wrapper took an argument it does not take")
    return len(calls)


def _gather_entry(table, ids):
    """K1's C entry point on prepared arguments, bf16 -> f32: the part of a
    wrapper call that is the ctypes call and the launch."""
    fn = gather_launcher()
    out = torch.empty((ids.numel(), table.shape[1]), dtype=torch.float32,
                      device="cuda")
    args = (table.data_ptr(), ids.data_ptr(), out.data_ptr(), table.shape[0],
            table.shape[1], ids.numel(), 1, 0, 0)
    return lambda: fn(*args, torch._C._cuda_getCurrentRawStream(0))


def _host_us(fn, calls: int = 2000, repeats: int = 5) -> float:
    """Median host microseconds per call of fn() over `repeats` runs of
    `calls` calls (the card keeps up: each call launches at most one
    kernel of a few microseconds)."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def _old_stream():
    """The stream lookup of a `torch.cuda.device` context, which every
    wrapper made on each call before `build.launch`."""
    with torch.cuda.device("cuda:0"):
        return torch.cuda.current_stream().cuda_stream


def _wrapper_host_us(wrapper, entry, library, checks, alloc=None,
                     route=None) -> dict:
    """Where a wrapper call's host time goes, microseconds per call: its
    argument checks, the output allocation (None: it allocates nothing),
    the stream lookup (`build.launch`'s, and a `torch.cuda.device`
    context's), the ctypes call with its launch, the whole wrapper, and
    beside it the library call and the route the wrapper replaced (None
    where there is none)."""
    parts = {"checks": checks, "alloc": alloc,
             "stream": lambda: (torch.cuda.current_device() == 0
                                and torch._C._cuda_getCurrentRawStream(0)),
             "stream_device_context": _old_stream, "ctypes_launch": entry,
             "wrapper": wrapper, "library": library, "route": route}
    return {what: None if f is None else _host_us(f)
            for what, f in parts.items()}


def _gather_timing(table: torch.Tensor, batches) -> dict:
    """K1 on the full table, each launch on the unique ids of another
    batch: events, device time, plain version and `index_select`."""
    k = len(batches)
    mean_n = sum(int(b.numel()) for b in batches) / k
    row_bytes = table.shape[1] * table.element_size()
    bytes_moved = 2 * mean_n * row_bytes + mean_n * batches[0].element_size()
    kernel_ms = cuda_ms(lambda i: embedding_gather(table, batches[i % k]), k)
    plain_ms = cuda_ms(lambda i: embedding_gather_ref(table, batches[i % k]),
                       k)
    library_ms = cuda_ms(
        lambda i: torch.index_select(table, 0, batches[i % k]), k)
    # back-to-back launches from Python measure the launch rate when a
    # launch costs the host more than the card; the profiler gives the
    # device time alone
    device_ms = {
        what: device_profile(lambda i, f=f: f(table, batches[i % k]), k,
                             K1 if what == "kernel" else None)[0]
        for what, f in (("kernel", embedding_gather),
                        ("plain", embedding_gather_ref),
                        ("library", lambda t, i: torch.index_select(t, 0, i)))}
    return {"batches": k, "width": table.shape[1], "mean_unique_ids": mean_n,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "kernel_device_ms": device_ms["kernel"],
            "plain_device_ms": device_ms["plain"],
            "library_device_ms": device_ms["library"],
            "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes_per_launch": bytes_moved}


def _position_timing(table: torch.Tensor, positions, batches, inverses
                     ) -> dict:
    """K1 by position with f32 output on the full table, each launch on
    the ids of another batch: events and device time, the plain version,
    `index_select` + `.to(float32)` (the library route, two calls) and the
    route it replaced (K1 on the unique ids, `[inv]`, `.to(float32)`, the
    inverses precomputed)."""
    k = len(positions)
    n = positions[0].numel()
    mean_u = sum(int(b.numel()) for b in batches) / k
    D = table.shape[1]
    # each distinct row read once (a repeat comes from L2), every position
    # written once in f32, the ids read once
    bytes_moved = (mean_u * D * table.element_size() + n * D * 4
                   + n * positions[0].element_size())
    fns = {
        "kernel": lambda i: embedding_gather(table, positions[i % k],
                                             torch.float32),
        "plain": lambda i: embedding_gather_ref(table, positions[i % k],
                                                torch.float32),
        "library": lambda i: torch.index_select(
            table, 0, positions[i % k]).to(torch.float32),
        "replaced": lambda i: embedding_gather(table, batches[i % k])[
            inverses[i % k]].to(torch.float32)}
    ev = {what: cuda_ms(f, k) for what, f in fns.items()}
    dev = {what: device_profile(
        f, k, K1 if what in ("kernel", "replaced") else None)[0]
        for what, f in fns.items()}
    return {"batches": k, "width": D, "positions": n,
            "mean_unique_ids": mean_u, "out_dtype": "float32",
            "kernel_ms": ev["kernel"], "plain_ms": ev["plain"],
            "library_ms": ev["library"], "replaced_ms": ev["replaced"],
            "kernel_device_ms": dev["kernel"],
            "plain_device_ms": dev["plain"],
            "library_device_ms": dev["library"],
            "replaced_device_ms": dev["replaced"],
            "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes_per_launch": bytes_moved,
            "bound_note": "distinct rows read once, positions written once "
                          "in f32, ids read once",
            "library_note": "index_select + .to(float32): two calls",
            "replaced_note": "K1 on the unique ids + [inv] + "
                             ".to(float32), the read it replaced"}


def _top(per: dict, n: int = 24) -> dict:
    """The n largest items of a profile, device ms each."""
    return dict(sorted(per.items(), key=lambda kv: -kv[1])[:n])


def _own_ms(per: dict, marker: str):
    """Device ms per call of the kernels whose name holds `marker`."""
    ms = sum(v for k, v in per.items() if marker in k)
    return ms or None


def _inverses(sparse: np.ndarray, batch: int, k: int):
    """The unique ids (int32, on the card), inverses (int64, on the card),
    unique counts and ids by position (int32, on the card) of k batches,
    computed with numpy."""
    batches, inverses, uniques, positions = [], [], [], []
    for i in range(k):
        ids = sparse[i * batch:(i + 1) * batch].reshape(-1)
        u, inv = np.unique(ids, return_inverse=True)
        batches.append(torch.as_tensor(u.astype(np.int32), device="cuda"))
        inverses.append(torch.as_tensor(inv.reshape(-1), device="cuda"))
        uniques.append(len(u))
        positions.append(torch.as_tensor(ids.astype(np.int32),
                                         device="cuda"))
    return batches, inverses, uniques, positions


# K1's, K2's and K4's kernels (gather and add forms), as torch.profiler
# names them
K1, K2 = "gather_rows", "scatter_rows"
HOT_GATHER, HOT_ADD = "hot_gather_rows", "hot_add_rows"

# K3's kernels, as torch.profiler names them
K3_KERNELS = ("count_ids", "alloc_segments", "place_positions", "sort_big",
              "sum_segments")


def _k3_ms(per: dict):
    """Device ms of K3's own kernels in a profile (its scratch memset is a
    fill kernel that other zeros share)."""
    return sum(v for name, v in per.items()
               if any(m in name for m in K3_KERNELS)) or None


def _push_cases(inverses, uniques, dfm_inverses, dfm_uniques):
    """(label, ids, grads_ints, grads_random, num_rows) cases on the
    card: f32 and bf16 grads, int32 and int64 ids."""
    rng = np.random.default_rng(1)
    g = torch.Generator(device="cuda").manual_seed(1)
    shapes = []
    # tests/test_pallas_kernels.py:62-76: duplicates and cold ids
    ids = np.where(rng.random(200) < 0.8, rng.integers(0, 256, 200),
                   1_000_000)
    shapes.append(("pallas-test H=256 D=128 N=200", ids, 256, 128))
    # num_rows no multiple of 512; D = 13 takes the one-column path
    shapes.append(("H=1000 D=13 N=3000", rng.integers(0, 1000, 3000),
                   1000, 13))
    # 10% of ids out of range, both sides
    ids = rng.integers(0, 3000, 6656)
    bad = rng.random(6656) < 0.1
    ids[bad] = np.where(rng.random(bad.sum()) < 0.5,
                        -rng.integers(1, 100, bad.sum()),
                        3000 + rng.integers(0, 100, bad.sum()))
    shapes.append(("H=3000 D=128 N=6656 10% out of range", ids, 3000, 128))
    shapes.append(("H=700 D=128 N=0", np.zeros(0, np.int64), 700, 128))
    # num_rows > N: most rows have no position and are written as zeros
    shapes.append(("H=4096 D=128 N=500 empty rows",
                   rng.integers(0, 4096, 500), 4096, 128))
    # one id at 3,000 of 6,656 positions: sorted in shared memory (more
    # than the 512 a piece ranks itself)
    ids = rng.integers(0, 3000, 6656)
    ids[rng.permutation(6656)[:3000]] = 11
    shapes.append(("H=3000 D=128 N=6656 one id at 3000", ids, 3000, 128))
    # one segment of every position at dfm's width: 832 pieces of 32,
    # sorted in device memory (more than the 8,192 a block sorts in
    # shared memory)
    n_dfm = dfm_inverses[0].numel()
    shapes.append((f"one id at all {n_dfm} positions H={dfm_uniques[0]} "
                   f"D=513", np.full(n_dfm, 5), dfm_uniques[0], 513))
    # dfm's main path: batch 0's inverse into its unique count
    shapes.append((f"dfm batch 0 N={n_dfm} U={dfm_uniques[0]} D=513",
                   dfm_inverses[0].cpu().numpy(), dfm_uniques[0], 513))
    # wdl's main path: serving batch 0's inverse into its unique count
    shapes.append((f"wdl batch 0 N={inverses[0].numel()} U={uniques[0]} "
                   f"D={EMB}", inverses[0].cpu().numpy(), uniques[0], EMB))
    for label, ids, H, D in shapes:
        n = len(ids)
        for dt in (torch.float32, torch.bfloat16):
            gi = torch.randint(-8, 9, (n, D), generator=g, device="cuda"
                               ).to(dt)
            gr = torch.randn((n, D), generator=g, device="cuda").to(dt)
            for idt in (torch.int32, torch.int64):
                yield (f"{label} {str(dt)[6:]} {str(idt)[6:]} ids",
                       torch.as_tensor(ids, dtype=idt, device="cuda"),
                       gi, gr, H)


def _push_timing(inverses, uniques, dim: int, drop: bool = False) -> dict:
    """K3 at one training shape, f32 grads [N, dim]: each launch on the
    inverse of another batch into its unique count. The whole call's
    device time (the memset and every kernel, listed by name), its events
    time, the plain version and zeros + `index_add_`. With `drop` the ids
    hold -1, which K3 drops; `index_add_` takes them remapped (before the
    timing) to one extra row."""
    k = len(inverses)
    n = inverses[0].numel()
    grads = torch.randn((n, dim), device="cuda")
    mean_u = sum(uniques) / k
    bytes_moved = (n * inverses[0].element_size() + n * dim * 4
                   + mean_u * dim * 4)
    extra = int(drop)
    lib_ids = [torch.where(ids >= 0, ids, u) if drop else ids
               for ids, u in zip(inverses, uniques)]

    def kern(i):
        return hot_onehot_push(inverses[i % k], grads, uniques[i % k])

    def plain(i):
        return hot_onehot_push_ref(inverses[i % k], grads, uniques[i % k])

    def library(i):
        return torch.zeros((uniques[i % k] + extra, dim),
                           device="cuda").index_add_(0, lib_ids[i % k],
                                                     grads)

    times = {what: cuda_ms(f, k) for what, f in
             (("kernel", kern), ("plain", plain), ("library", library))}
    prof = {what: device_profile(f, k, "sum_segments" if what == "kernel"
                                 else None)
            for what, f in (("kernel", kern), ("plain", plain),
                            ("library", library))}
    by_name = dict(sorted(prof["kernel"][1].items(), key=lambda kv: -kv[1]))
    return {"n": n, "dim": dim, "launches_per_shape": k,
            "mean_unique_ids": mean_u,
            "kernel_ms": times["kernel"], "plain_ms": times["plain"],
            "library_ms": times["library"],
            "kernel_device_ms": prof["kernel"][0],
            "kernel_device_ms_by_name": by_name,
            "own_kernels_device_ms": _k3_ms(by_name),
            "plain_device_ms": prof["plain"][0],
            "library_device_ms": prof["library"][0],
            "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes_per_launch": bytes_moved}


def phase_kernel_push(inverses, uniques, dfm_inverses, dfm_uniques) -> dict:
    """K3 against its plain version: integer-valued grads (exact sums)
    bit for bit, random grads within 1e-6 * sum|g| per element, and two
    launches bit-identical. Then timed at both training shapes: wdl, the
    inverses of the 64 serving batches (N = 6,656) at width 128; dfm, the
    inverses of 8 dfm batches (N = 26,624) at width 513."""
    cases, worst = 0, 0.0
    for label, ids, gi, gr, H in _push_cases(inverses, uniques,
                                             dfm_inverses, dfm_uniques):
        got = hot_onehot_push(ids, gi, H)
        if not torch.equal(got, hot_onehot_push_ref(ids, gi, H)):
            raise AssertionError(f"hot_onehot_push differs from its plain "
                                 f"version on integer grads ({label})")
        a, b = hot_onehot_push(ids, gr, H), hot_onehot_push(ids, gr, H)
        if not torch.equal(a, b):
            raise AssertionError(f"hot_onehot_push is not deterministic "
                                 f"({label})")
        want = hot_onehot_push_ref(ids, gr, H)
        bound = 1e-6 * hot_onehot_push_ref(ids, gr.abs(), H)
        err = (a - want).abs()
        if not bool((err <= bound).all()):
            raise AssertionError(f"hot_onehot_push differs from its plain "
                                 f"version beyond 1e-6*sum|g| ({label}): "
                                 f"max {float(err.max())}")
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
        cases += 1
    torch.cuda.synchronize()

    out = {"name": "hot_onehot_push", "cases": cases, "max_abs_err": worst,
           **_push_timing(inverses, uniques, EMB),
           "dfm": _push_timing(dfm_inverses, dfm_uniques, DFM_EMB + 1),
           "bound_note": "ids + f32 grads read once, output written once; "
                         "the kernel's own scratch is left out",
           "device_note": "kernel_device_ms is the whole call: the "
                          "scratch memset and the five kernels"}
    emit({"phase": "kernel:hot_onehot_push", **out})
    return out


# the dedup kernel, as torch.profiler names it
UNIQUE_KERNEL = "unique_fill_kernel"


def _unique_ids(kind: str, n: int, rng) -> np.ndarray:
    """n int32 ids of one kind: all equal, all distinct, Zipf 1.2 over
    the table's rows, negative, the int32 extremes among random ones, or
    distinct ids of which all but one lie in one of the kernel's parts."""
    if kind == "equal":
        return np.full(n, 1234567, np.int32)
    if kind == "distinct":
        return rng.choice(FULL_ROWS, n, replace=False).astype(np.int32)
    if kind == "zipf":
        return ((rng.zipf(1.2, n) - 1) % FULL_ROWS).astype(np.int32)
    if kind == "negative":
        return rng.integers(-5000, 5000, n).astype(np.int32)
    if kind == "one_part":      # distinct, and all but one in one block
        a = rng.permutation(n).astype(np.int32)
        a[a == n - 1] = 1 << 30
        return a
    lim = np.iinfo(np.int32)
    a = rng.integers(lim.min, lim.max, n, endpoint=True).astype(np.int32)
    a[::3], a[1::5], a[2::7] = lim.max, -lim.max, lim.min
    return a


def _unique_timing(batches: list, size: int) -> dict:
    """The kernel against the library chain on k batches of n int32 ids
    (each call on another batch): events ms of eager calls, device ms
    from the profiler, and each captured alone as a graph of k calls
    whose replays run back to back behind a sleep kernel (card ms a
    call, as inside a step's graph)."""
    k, n = len(batches), batches[0].numel()

    def kern(i):
        return unique_ops.unique_fill(batches[i % k], size, -1)

    def chain(i):
        return unique_ops.unique_fill_ref(batches[i % k], size, -1)

    def graph_ms(fn, reps: int = 50) -> float:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for i in range(k):
                fn(i)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(k):
                fn(i)
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(200_000_000)
            start.record()
            for _ in range(reps):
                g.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / (reps * k))
        return statistics.median(times)

    before = unique_ops.unique_fill.launches
    times = {what: cuda_ms(f, k) for what, f in
             (("kernel", kern), ("chain", chain))}
    prof = {what: device_profile(f, k, UNIQUE_KERNEL if what == "kernel"
                                 else None)
            for what, f in (("kernel", kern), ("chain", chain))}
    graphs = {what: graph_ms(f) for what, f in
              (("kernel", kern), ("chain", chain))}
    unique_ops.unique_fill.launches = before
    bytes_moved = n * 4 + size * 4 + n * 8
    return {"n": n, "size": size, "calls": k,
            "kernel_ms": times["kernel"], "chain_ms": times["chain"],
            "kernel_device_ms": prof["kernel"][0],
            "chain_device_ms": prof["chain"][0],
            "chain_device_ms_by_name": _top(prof["chain"][1]),
            "kernel_graph_ms": graphs["kernel"],
            "chain_graph_ms": graphs["chain"],
            "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes_per_call": bytes_moved}


def phase_kernel_unique() -> dict:
    """The dedup's unique_fill kernel against the library chain it
    replaces (`unique_fill_ref` on the card): uniq and inv bit for bit
    at n of 1, 63, 64, a wdl step's 6,656 and the capacity, for ids all
    equal, all distinct, Zipf 1.2, negative, at the int32 extremes and
    distinct in one of the kernel's parts,
    with `size` below, at and above n and a fill of -1 and of the table's
    rows; one launch a call; the rule (`ops.embedding.unique_fill`)
    sending the capacity + 1 and int64 ids to the chain. Then timed at
    n = 6,656 (the ids of 64 wdl batches of synthetic_ctr_data) and at
    the capacity (Zipf 1.2 ids)."""
    cap = unique_ops.CAPACITY
    rng = np.random.default_rng(3)
    cases = 0
    for n in (1, 63, 64, BATCH * 26, cap):
        for kind in ("equal", "distinct", "zipf", "negative", "extremes",
                     "one_part"):
            ids = torch.as_tensor(_unique_ids(kind, n, rng), device="cuda")
            for size in (max(n // 3, 1), n, n + 37):
                for fill in (-1, FULL_ROWS):
                    before = unique_ops.unique_fill.launches
                    got = embedding_ops.unique_fill(ids, size, fill)
                    want = unique_ops.unique_fill_ref(ids, size, fill)
                    if unique_ops.unique_fill.launches != before + 1 or \
                            got[0].dtype != want[0].dtype or \
                            not torch.equal(got[0], want[0]) or \
                            not torch.equal(got[1], want[1]):
                        raise AssertionError(
                            f"unique_fill differs from the chain (n {n}, "
                            f"{kind}, size {size}, fill {fill})")
                    cases += 1
    for ids in (torch.as_tensor(_unique_ids("zipf", cap + 1, rng),
                                device="cuda"),
                torch.as_tensor(_unique_ids("zipf", 6656, rng),
                                device="cuda").long()):
        before = unique_ops.unique_fill.launches
        got = embedding_ops.unique_fill(ids, ids.numel(), -1)
        want = unique_ops.unique_fill_ref(ids, ids.numel(), -1)
        if unique_ops.unique_fill.launches != before or \
                not (torch.equal(got[0], want[0])
                     and torch.equal(got[1], want[1])):
            raise AssertionError(f"the dedup's rule took the kernel or "
                                 f"differs for {ids.numel()} {ids.dtype} "
                                 f"ids")
    torch.cuda.synchronize()
    _, sparse, _ = synthetic_ctr_data(get_model("wdl_criteo").spec,
                                      64 * BATCH, seed=0,
                                      num_rows=FULL_ROWS)
    step = [torch.as_tensor(sparse[i * BATCH:(i + 1) * BATCH].reshape(-1)
                            .astype(np.int32), device="cuda")
            for i in range(64)]
    full = [torch.as_tensor(_unique_ids("zipf", cap, rng), device="cuda")
            for _ in range(64)]
    out = {"name": "unique_fill", "cases": cases, "max_abs_err": 0.0,
           "wdl_step": _unique_timing(step, step[0].numel()),
           "capacity": _unique_timing(full, cap),
           "bound_note": "ids read once, uniq and inv written once; the "
                         "kernel is a cluster of 8 blocks, bound by its "
                         "chain of block-wide steps"}
    emit({"phase": "kernel:unique_fill", **out})
    return out


# K1's pooled form, as torch.profiler names it
POOL_KERNEL = "gather_pool_rows"
DLRM = "dlrm_dcnv2_criteo1tb"
DLRM_BATCH = 8192       # one of 8 GPUs' share of MLPerf's 65,536
# the benchmark cell's table: criteo1tb's five 40,000,000-row tables at a
# hash cap of 24,000,000 rows, the other 21 as published (63.58 GB in f32)
DLRM_ROWS = 124_184_588
# the launch counts' table: the same tables at a lower cap (2.1 GB in f32)
DLRM_COUNT_ROWS = 1 << 22


def phase_kernel_pool() -> dict:
    """K1's pooled form (`gather_pool_rows`, the bags of a multi-hot
    model) against its plain version on the card, bit for bit: f32 and
    bf16 tables, int32 and int64 ids, widths 128 (16-byte vectors), 513
    and 8 (the scalar loop), DLRM-DCNv2's 26 bags and bags of 0, 1 and 5,
    ids outside the table and one id twice in a bag; a bag of one against
    K1 by position; one launch a call. K3 through its row map against K3
    on the expanded gradient, bit for bit. Then at DLRM-DCNv2's step
    (batch 8,192, 214 ids of `synthetic_multihot_data`) over the cell's
    124,184,588 rows (`DLRM_ROWS`) at width 128 f32, 15.9G elements: the
    kernel against its plain version bit for bit (`max_abs_err` from that
    call) and against the library's EmbeddingBag within 1e-5 of the
    largest pooled value, then timed: events and device ms, the bound
    (each distinct row read once, the ids once, the pooled rows written
    once), the plain version and EmbeddingBag, and K3 through the map
    against K3 on the expanded copy."""
    from herald_tpu_torch.data import PORT_DATASETS, synthetic_multihot_data
    rng = np.random.default_rng(4)
    dlrm = PORT_DATASETS["criteo1tb"].bag_sizes
    cases = 0
    for bags in (dlrm, (0, 1, 5, 1)):
        off = torch.tensor(np.concatenate([[0], np.cumsum(bags)]),
                           dtype=torch.int32, device="cuda")
        P = sum(bags)
        for dtype in (torch.float32, torch.bfloat16):
            for W in (128, 513, 8):
                table = (0.1 * torch.randn((5000, W), device="cuda")).to(dtype)
                table[7] = -0.0
                for id_dtype in (torch.int32, torch.int64):
                    ids = rng.zipf(1.2, (64, P)) % 5000
                    ids[0, :3] = (-1, 5000, 7)
                    ids[1, :2] = 7
                    ids = torch.as_tensor(ids, dtype=id_dtype, device="cuda")
                    before = k1_ops.gather_pool_rows.launches
                    got = k1_ops.gather_pool_rows(table, ids, off)
                    want = k1_ops.gather_pool_rows_ref(table, ids, off)
                    if k1_ops.gather_pool_rows.launches != before + 1 or \
                            not torch.equal(got.view(torch.int32),
                                            want.view(torch.int32)):
                        raise AssertionError(
                            f"gather_pool_rows differs from its plain "
                            f"version ({bags[:4]}, {dtype}, W {W}, "
                            f"{id_dtype})")
                    for k in np.flatnonzero(np.asarray(bags) == 1):
                        k1 = embedding_gather(table, ids[:, int(off[k])]
                                              .contiguous(), torch.float32)
                        if not torch.equal(got[:, k].view(torch.int32),
                                           k1.view(torch.int32)):
                            raise AssertionError(
                                "a bag of one is not K1 by position")
                    cases += 1
    # K3 through the map, against the expanded gradient
    nb, P = len(dlrm), sum(dlrm)
    B = DLRM_BATCH
    bag_of = np.repeat(np.arange(nb), dlrm)
    rows = torch.tensor((np.arange(B)[:, None] * nb + bag_of[None])
                        .reshape(-1), dtype=torch.int32, device="cuda")
    _, sparse, _ = synthetic_multihot_data(PORT_DATASETS["criteo1tb"], B,
                                           seed=0, num_rows=DLRM_ROWS)
    ids = torch.as_tensor(sparse.astype(np.int32), device="cuda")
    uniq, inv = embedding_ops.unique_static(ids, ids.numel())
    gp = torch.randn((B * nb, EMB), device="cuda") * 1e-4
    gi = torch.randint(-4, 5, (B * nb, EMB), device="cuda").float()
    n = ids.numel()
    for g in (gp, gi):
        a = hot_onehot_push(inv, g, n, rows)
        b = hot_onehot_push(inv, g.index_select(0, rows.long()), n)
        if not torch.equal(a, b):
            raise AssertionError("K3 through its map differs from K3 on "
                                 "the expanded gradient")
    if not torch.equal(hot_onehot_push(inv, gi, n, rows), hot_onehot_push_ref(
            inv, gi, n, rows)):
        raise AssertionError("K3 through its map differs from its plain "
                             "version on integer grads")
    cases += 3
    # timed at the step's shape
    table = torch.empty((DLRM_ROWS, EMB), device="cuda").normal_().mul_(0.01)
    off = torch.tensor(np.concatenate([[0], np.cumsum(dlrm)]),
                       dtype=torch.int32, device="cuda")
    flat = ids.reshape(-1).long()
    starts = (torch.arange(B, device="cuda")[:, None] * P
              + off[:-1].long()[None]).reshape(-1)
    u = int((uniq >= 0).sum())
    bytes_moved = u * EMB * 4 + n * 4 + B * nb * EMB * 4 + 4 * (nb + 1)

    def kern(_i):
        return k1_ops.gather_pool_rows(table, ids, off)

    def bag(_i):
        return torch.nn.functional.embedding_bag(flat, table, starts,
                                                 mode="sum")

    got, want = kern(0), k1_ops.gather_pool_rows_ref(table, ids, off)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("gather_pool_rows differs from its plain "
                             "version at DLRM-DCNv2's step")
    err = float((got - want).abs().max())
    lib = float((got.view(-1, EMB) - bag(0)).abs().max())
    if lib > 1e-5 * float(want.abs().max()):
        raise AssertionError(f"gather_pool_rows differs from EmbeddingBag "
                             f"by {lib} at DLRM-DCNv2's step")
    cases += 1
    del got, want
    before = k1_ops.gather_pool_rows.launches
    prof = device_profile(kern, 20, POOL_KERNEL)
    out = {"name": "gather_pool_rows", "cases": cases, "max_abs_err": err,
           "batch": B, "rows": DLRM_ROWS, "positions": n, "distinct": u,
           "kernel_ms": cuda_ms(kern, 20),
           "kernel_device_ms": _own_ms(prof[1], POOL_KERNEL),
           "plain_ms": cuda_ms(lambda i: k1_ops.gather_pool_rows_ref(
               table, ids, off), 2, repeats=3, warmup=1),
           "embedding_bag_ms": cuda_ms(bag, 20),
           "embedding_bag_device_ms": device_profile(bag, 10)[0],
           "embedding_bag_max_abs_diff": lib,
           "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "bytes_per_call": bytes_moved,
           "k3_map_ms": cuda_ms(lambda i: hot_onehot_push(inv, gp, n, rows),
                                5),
           "k3_expanded_ms": cuda_ms(lambda i: hot_onehot_push(
               inv, gp.index_select(0, rows.long()), n), 5)}
    k1_ops.gather_pool_rows.launches = before
    del table
    _free()
    emit({"phase": "kernel:gather_pool_rows", **out})
    return out


def phase_train_dlrm(K=8) -> dict:
    """DLRM-DCNv2 through the main path at its published widths and batch
    8,192 over `DLRM_COUNT_ROWS` rows (`table_sizes_within`'s hash cap) at
    width 128 f32: a warm-up chunk and two chunks of K steps through
    Engine.train_epoch, then 8 batches through predict and 4 through
    evaluate, the kernel counters reset before each. Every train step
    launches K1's pooled form, K3 (through its row map) and K2 once, and
    neither K1 by position nor unique_fill (its 1,753,088 ids take the
    library's dedup); every scored batch launches K1's pooled form once
    and nothing else. The first step's loss and predict's probabilities
    are held to the tower over the plain pooled read
    (`gather_pool_rows_ref`): the loss within 1e-5 (relative), the
    probabilities within 1e-6."""
    from herald_tpu_torch.data import PORT_DATASETS, synthetic_multihot_data
    B = DLRM_BATCH
    eng = Engine(HeraldConfig(model=DLRM, batch_size=B, embedding_dim=EMB),
                 table_rows=DLRM_COUNT_ROWS, device="cuda")
    state = eng.init_state(0)
    dense, sparse, labels = synthetic_multihot_data(
        PORT_DATASETS["criteo1tb"], 2 * K * B, seed=0,
        num_rows=DLRM_COUNT_ROWS)
    chunks = [_stage(dense, sparse, labels, 0, K, B),
              _stage(dense, sparse, labels, K * B, K, B)]
    off = torch.tensor(np.concatenate([[0], np.cumsum(eng.model.bags)]),
                       dtype=torch.int32, device="cuda")

    def plain_logits(d, s):
        pooled = k1_ops.gather_pool_rows_ref(state.table, s, off)
        return eng.model.apply_pooled(state.dense, pooled, d)

    d0, s0, y0 = (c[0] for c in chunks[0])
    with torch.no_grad():
        want_loss = float(bce_with_logits(plain_logits(d0, s0), y0))
    per_step = {"gather_pool_rows": 1, "hot_onehot_push": 1,
                "rows_scatter_add": 1}
    for kern in KERNELS.values():
        kern.launches = 0
    state, stats = eng.train_epoch(state, *chunks[0], steps=K)  # warm-up
    losses = [stats["loss"]]
    t0 = time.perf_counter()
    for c in (1, 0):
        state, stats = eng.train_epoch(state, *chunks[c], steps=K)
        losses.append(stats["loss"])
    losses = torch.cat(losses).cpu()
    train_s = time.perf_counter() - t0
    train = {name: kern.launches for name, kern in KERNELS.items()}
    if train != _want(per_step, 3 * K):
        raise AssertionError(f"the train:dlrm path launched {train}; "
                             f"expected {_want(per_step, 3 * K)}")
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError("non-finite DLRM-DCNv2 training loss")
    if abs(float(losses[0]) - want_loss) > 1e-5 * abs(want_loss):
        raise AssertionError(f"DLRM-DCNv2's first loss {float(losses[0])} "
                             f"against the plain read's {want_loss}")

    for kern in KERNELS.values():
        kern.launches = 0
    probs_err = 0.0
    for i in range(8):
        d, s = dense[i * B:(i + 1) * B], sparse[i * B:(i + 1) * B]
        got = eng.predict(state, d, s)
        with torch.no_grad():
            want = torch.sigmoid(plain_logits(
                torch.as_tensor(d, device="cuda"),
                torch.as_tensor(s.astype(np.int32), device="cuda")))
        probs_err = max(probs_err, float((got - want).abs().max()))
    if probs_err > 1e-6:
        raise AssertionError(f"DLRM-DCNv2's predict differs from the plain "
                             f"read by {probs_err}")
    ev = eng.evaluate(state, dense[:4 * B], sparse[:4 * B],
                      labels[:4 * B])
    if not (np.isfinite(ev["auc"]) and np.isfinite(ev["acc"])):
        raise AssertionError(f"DLRM-DCNv2's evaluate gave {ev}")
    scored = {name: kern.launches for name, kern in KERNELS.items()}
    if scored != _want({"gather_pool_rows": 1}, 12):
        raise AssertionError(f"the eval:dlrm path launched {scored}; "
                             f"expected {_want({'gather_pool_rows': 1}, 12)}")
    out = {"model": DLRM, "batch": B, "rows": DLRM_COUNT_ROWS,
           "steps": 3 * K, "launches": train, "eval_launches": scored,
           "first_loss": float(losses[0]), "plain_first_loss": want_loss,
           "last_loss": float(losses[-1]), "probs_max_abs_err": probs_err,
           "eval": ev, "train_steps_per_s": 2 * K / train_s}
    del state, eng, chunks
    _free()
    emit({"phase": "train:dlrm", **out})
    return out


def _pool_entry(kp: dict, launches_by_path: dict) -> dict:
    """K1's pooled form's line of the `kernels` summary."""
    return {"name": "gather_pool_rows", "route": "cuda",
            "source": "herald_tpu_torch/ops/kernels/csrc/embedding_gather.cu",
            "replaces": "none: the JAX package has no multi-hot model",
            "launches": sum(launches_by_path.values()),
            "launches_by_path": launches_by_path, "cases": kp["cases"],
            "max_abs_err": kp["max_abs_err"],
            **{k: kp[k] for k in ("kernel_ms", "kernel_device_ms",
                                  "plain_ms", "embedding_bag_ms",
                                  "bound_ms")}}


def _scatter_cases():
    """(label, table, unique ids, grads, lr) cases on the card: every
    table and grad dtype without lr, and f32 grads with lr."""
    rng = np.random.default_rng(2)
    g = torch.Generator(device="cuda").manual_seed(2)
    lr = torch.tensor(0.37, device="cuda")
    for tdt in (torch.float32, torch.bfloat16):
        for gdt, rate in ((torch.float32, None), (torch.bfloat16, None),
                          (torch.float32, lr)):
            for R, D, N, oob, odd in (
                    (104, 128, 6, 0.0, False),   # test_pallas_kernels
                    (1001, 13, 300, 0.0, False),
                    (1001, 13, 300, 0.1, True),
                    (100_000, 128, 3491, 0.1, False),
                    (100_000, 513, 13_000, 0.1, False),  # dfm's width
                    # odd rows of 513: no row 16-byte aligned
                    (100_000, 513, 13_000, 0.1, True),
                    (512, 128, 0, 0.0, False)):
                ids = rng.permutation(np.arange(1, R, 2) if odd
                                      else np.arange(R))[:N]
                bad = rng.random(N) < oob
                ids[bad] = np.where(rng.random(bad.sum()) < 0.5,
                                    -rng.integers(1, 10, bad.sum()),
                                    R + rng.integers(0, 10, bad.sum()))
                yield (f"{str(tdt)[6:]} table {str(gdt)[6:]} grads R={R} "
                       f"D={D} N={N}{' odd ids' if odd else ''}"
                       f"{' lr' if rate is not None else ''}",
                       torch.randn((R, D), generator=g, device="cuda"
                                   ).to(tdt),
                       torch.as_tensor(ids, device="cuda"),
                       (0.01 * torch.randn((N, D), generator=g,
                                           device="cuda")).to(gdt), rate)


def phase_kernel_scatter(table: torch.Tensor, batches) -> dict:
    """K2 against its plain version, bit for bit (with lr: against the
    plain version on `-lr * grads`); an lr it does not take raises. Then
    at full width: the unique ids of serving batch 0 into the 33.7M-row
    bf16 table with f32 deltas and lr (the touched rows are restored
    after). Timed with zero deltas, which leave the table as it is and
    move the same bytes: with lr (the main path) beside the route it
    replaced, and without lr."""
    cases = 0
    for label, tab, ids, grads, lr in _scatter_cases():
        want = rows_scatter_add_ref(tab.clone(), ids,
                                    grads if lr is None else -lr * grads)
        got = rows_scatter_add(tab, ids, grads, lr)
        if not torch.equal(got, want):
            raise AssertionError(f"rows_scatter_add differs from its plain "
                                 f"version ({label})")
        cases += 1
    ids = batches[0]
    lr = torch.tensor(0.01, device="cuda")
    keep = table[ids.long()].clone()
    deltas = 0.1 * torch.randn((ids.numel(), table.shape[1]), device="cuda")
    rows_scatter_add(table, ids, deltas, lr)
    want = keep + (-lr * deltas).to(table.dtype)
    if not torch.equal(table[ids.long()], want):
        raise AssertionError("rows_scatter_add differs from its plain "
                             "version at full width")
    table.index_copy_(0, ids.long(), keep)
    cases += 1
    small = torch.zeros((8, 4), device="cuda")
    refused = _refusals(
        lambda: rows_scatter_add(small, ids[:2], small[:2].bfloat16(), lr),
        lambda: rows_scatter_add(small, ids[:2], small[:2], lr.cpu()),
        lambda: rows_scatter_add(small, ids[:2], small[:2], lr[None]),
        lambda: rows_scatter_add(small, ids[:2], small[:2], 0.01))
    torch.cuda.synchronize()
    zeros = torch.zeros((ids.numel(), table.shape[1]), device="cuda")
    fn = scatter_launcher()
    args = (table.data_ptr(), ids.data_ptr(), zeros.data_ptr(),
            lr.data_ptr(), table.shape[0], table.shape[1], ids.numel(), 1, 0,
            0)
    out = {"name": "rows_scatter_add", "cases": cases, "max_abs_err": 0.0,
           "refused_other_lr": refused, **_scatter_timing(table, batches),
           "wrapper_host_us": _wrapper_host_us(
               lambda: rows_scatter_add(table, ids, zeros, lr),
               lambda: fn(*args, torch._C._cuda_getCurrentRawStream(0)),
               lambda: table.index_add_(0, ids, zeros.to(table.dtype)),
               lambda: check_scatter_args(table, ids, zeros, lr))}
    emit({"phase": "kernel:rows_scatter_add", **out})
    return out


def _scatter_timing(table: torch.Tensor, batches) -> dict:
    """K2 into the full table with zero f32 deltas (which leave the table
    as it is and move the same bytes), each launch on the unique ids of
    another batch: with lr, events and device time, the plain version,
    `index_add_` and the route it replaced (`-lr * g`, then K2 without
    lr); and K2 without lr under "without_lr"."""
    k = len(batches)
    keep = table[batches[0].long()].clone()
    zeros = [torch.zeros((b.numel(), table.shape[1]), device="cuda")
             for b in batches]
    lr = torch.tensor(0.01, device="cuda")
    mean_n = sum(int(b.numel()) for b in batches) / k
    row_bytes = table.shape[1] * table.element_size()
    bytes_moved = (mean_n * batches[0].element_size()
                   + mean_n * table.shape[1] * 4 + 2 * mean_n * row_bytes)
    fns = {
        "kernel": lambda i: rows_scatter_add(table, batches[i % k],
                                             zeros[i % k], lr),
        "plain": lambda i: rows_scatter_add_ref(table, batches[i % k],
                                                zeros[i % k], lr),
        "library": lambda i: table.index_add_(0, batches[i % k],
                                              zeros[i % k].to(table.dtype)),
        "replaced": lambda i: rows_scatter_add(table, batches[i % k],
                                               -lr * zeros[i % k]),
        "without_lr": lambda i: rows_scatter_add(table, batches[i % k],
                                                 zeros[i % k])}
    ev = {what: cuda_ms(f, k) for what, f in fns.items()}
    prof = {what: device_profile(
        f, k, K2 if what in ("kernel", "without_lr") else None)
        for what, f in fns.items()}
    if not torch.equal(table[batches[0].long()], keep):
        raise AssertionError("zero deltas changed the table")
    return {"batches": k, "width": table.shape[1], "mean_unique_ids": mean_n,
            "kernel_ms": ev["kernel"], "plain_ms": ev["plain"],
            "library_ms": ev["library"], "replaced_ms": ev["replaced"],
            "kernel_device_ms": _own_ms(prof["kernel"][1], K2),
            "wrapper_device_ms": prof["kernel"][0],
            "plain_device_ms": prof["plain"][0],
            "library_device_ms": prof["library"][0],
            "replaced_device_ms": prof["replaced"][0],
            "without_lr": {
                "kernel_ms": ev["without_lr"],
                "kernel_device_ms": _own_ms(prof["without_lr"][1], K2)},
            "bound_ms": (bytes_moved + 4) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes_per_launch": bytes_moved + 4,
            "bound_note": "ids, f32 deltas and lr read once, touched bf16 "
                          "rows read and written once",
            "replaced_note": "-lr * g, then K2 without lr, as the SGD "
                             "step called it before K2 took lr"}


def _request(url, data=None):
    req = urllib.request.Request(
        url, data=None if data is None else json.dumps(data).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _served_by_entry_point(ckpt, cfg_path, rows, dense, sparse):
    """The probabilities `python -m herald_tpu_torch.serve` gives for one
    request, from a checkpoint and its config, in a subprocess stopped
    after it answers."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "herald_tpu_torch.serve", "--ckpt", str(ckpt),
         "--config", str(cfg_path), "--rows", str(rows), "--port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        seen = []
        for line in proc.stdout:          # until it says where it serves
            seen.append(line)
            m = re.search(r"serving .* at http://127\.0\.0\.1:(\d+)", line)
            if m:
                break
        else:
            raise AssertionError("serve entry point did not start:\n"
                                 + "".join(seen))
        code, resp = _request(f"http://127.0.0.1:{m.group(1)}/score",
                              {"dense": dense.tolist(),
                               "sparse": sparse.tolist()})
        assert code == 200, (code, resp)
        return np.asarray(resp["probs"], np.float32)
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        proc.stdout.close()


@torch.inference_mode()
def reference_scores(eng: Engine, state, dense, sparse,
                     apply=None) -> np.ndarray:
    """The engine's eval step with K1 replaced by its plain version, and
    the tower by `apply` (default: the model's own), padded and chunked as
    the Scorer does."""
    apply = apply or eng.model.apply
    B = eng.cfg.batch_size
    out = []
    for i in range(0, len(sparse), B):
        d, s = dense[i:i + B], sparse[i:i + B]
        m = len(s)
        d = np.concatenate([d, np.repeat(d[-1:], B - m, axis=0)])
        s = np.concatenate([s, np.repeat(s[-1:], B - m, axis=0)])
        ids = torch.as_tensor(s.astype(np.int32), device="cuda")
        uniq, inv = torch.unique(ids.reshape(-1), sorted=True,
                                 return_inverse=True)
        emb = embedding_gather_ref(state.table, uniq)[inv].reshape(
            B, -1, eng.width)
        logits = apply(state.dense, emb.float(),
                       torch.as_tensor(d, device="cuda"))
        out.append(torch.sigmoid(logits)[:m].cpu().numpy())
    return np.concatenate(out)


def plain_dfm_apply(params, emb, dense):
    """DeepFM's tower with K5 replaced by its plain version: the JAX
    package's inline formula (herald_tpu/models/dfm.py:37-53), whose
    backward is autograd's."""
    first, second = emb[:, :, 0], emb[:, :, 1:]
    y1 = (dense @ params["FM_W"]).reshape(-1) + first.sum(dim=1)
    y2 = fm_second_order_ref(second)
    n = sum(1 for k in params if re.fullmatch(r"W\d+", k))
    h = mlp_apply(params, second.reshape(emb.shape[0], -1), n)
    return y1 + y2 + h.reshape(-1)


def _want(per_unit: dict, units: int) -> dict:
    """Each kernel's expected launches: `per_unit` per batch or step."""
    return {name: per_unit.get(name, 0) * units for name in KERNELS}


def phase_serve(eng: Engine, state, label="serve", plain_apply=None,
                per_batch=None, tol=1e-6) -> dict:
    """The main path: HTTP requests, predict latency, throughput and
    evaluate, all through Engine.predict. Kernel counts are zeroed just
    before and read just after: `per_batch` launches of each kernel for
    every scored batch (default: one K1). The served scores are held to
    the eval step with the plain versions within `tol`; the eval step
    waits for the card 0 times; 8 batches and evaluate through the engine
    built with cuda_graphs=False equal the captured ones bit for bit."""
    per_batch = per_batch or {"embedding_gather": 1}
    B = eng.cfg.batch_size
    spec = eng.model.spec
    dense, sparse, labels = synthetic_ctr_data(spec, 64 * B, seed=1,
                                               num_rows=FULL_ROWS)
    scorer = Scorer(eng, state)
    srv = make_server(scorer, 0)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    served = {}
    requests = (1, B, 2 * B + 88)
    for k in KERNELS.values():
        k.launches = 0
    batches = 0
    try:
        code, health = _request(url + "/health")
        assert code == 200 and health == {"status": "ok",
                                          "model": eng.model.name,
                                          "step": 0, "batch": B}, health
        for n in requests:
            code, resp = _request(url + "/score",
                                  {"dense": dense[:n].tolist(),
                                   "sparse": sparse[:n].tolist()})
            assert code == 200 and resp["n"] == n, (code, resp.get("error"))
            p = np.asarray(resp["probs"], np.float32)
            assert p.shape == (n,) and np.isfinite(p).all() \
                and (p >= 0).all() and (p <= 1).all()
            served[n] = p
            batches += -(-n // B)
        code, err = _request(url + "/score", {"sparse": [[0, 1]]})
        assert code == 400 and "error" in err, (code, err)
        code, err = _request(url + "/score",
                             {"dense": dense[:1].tolist(),
                              "sparse": (sparse[:1] + FULL_ROWS).tolist()})
        assert code == 400 and "out of range" in err["error"], (code, err)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)

    d, s = dense[:B], sparse[:B]
    lat = []
    for _ in range(60):
        t0 = time.perf_counter()
        eng.predict(state, d, s)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    batches += 60
    nb = 200
    t0 = time.perf_counter()
    for i in range(nb):
        j = (i % 64) * B
        eng.predict(state, dense[j:j + B], sparse[j:j + B])
    torch.cuda.synchronize()
    ex_s = nb * B / (time.perf_counter() - t0)
    batches += nb
    t0 = time.perf_counter()
    ev = eng.evaluate(state, dense, sparse, labels)
    eval_s = time.perf_counter() - t0
    batches += 64
    launches = {name: k.launches for name, k in KERNELS.items()}
    if launches != _want(per_batch, batches):
        raise AssertionError(f"the {label} path launched {launches}, "
                             f"expected {_want(per_batch, batches)}")
    if not (np.isfinite(ev["auc"]) and np.isfinite(ev["acc"])):
        raise AssertionError(f"evaluate gave {ev}")

    # the eval step on a batch already on the card, replayed: it reads by
    # position and never waits for the card (outside the counted window)
    d_t = torch.as_tensor(dense[:B].astype(np.float32), device="cuda")
    s_t = torch.as_tensor(sparse[:B].astype(np.int32), device="cuda")
    torch.cuda.synchronize()
    before = {name: k.launches for name, k in KERNELS.items()}
    waits, sites = _count_host_waits(lambda: eng.predict(state, d_t, s_t))
    step_launches = {name: k.launches - before[name]
                     for name, k in KERNELS.items()}
    if waits or step_launches != _want(per_batch, 1):
        raise AssertionError(f"the {label} eval step waited {waits} times "
                             f"({sites}) and launched {step_launches}")

    # captured against uncaptured scoring of the same state: 8 batches and
    # evaluate, bit for bit
    eager = Engine(eng.cfg, model=eng.model, table_rows=eng.num_rows,
                   device=DEVICE, cuda_graphs=False)
    got = [eng.predict(state, dense[i * B:(i + 1) * B],
                       sparse[i * B:(i + 1) * B]) for i in range(8)]
    want = [eager.predict(state, dense[i * B:(i + 1) * B],
                          sparse[i * B:(i + 1) * B]) for i in range(8)]
    captured = {"batches": 8, "scores_differ": _differ(got, want),
                "evaluate_equal": eager.evaluate(state, dense, sparse,
                                                 labels) == ev,
                "graphs": eng.graphs.captures}
    if captured["scores_differ"] or not captured["evaluate_equal"]:
        raise AssertionError(f"captured scoring differs from uncaptured: "
                             f"{captured}")

    # where one predict's time goes (outside the counted window)
    busy, per, host, _ = device_profile(
        lambda i: eng.predict(state, dense[(i % 64) * B:][:B],
                              sparse[(i % 64) * B:][:B]), 50)
    top = _top(per)
    profile = {"device_busy_ms": busy, "host_ms_profiled": host,
               "device_idle_share": None if busy is None else 1 - busy / host,
               "top_device_ms": top, "busy_gate": _busy_gate(label, busy)}

    n3 = requests[-1]
    ref = reference_scores(eng, state, dense[:n3], sparse[:n3], plain_apply)
    err = float(np.abs(served[n3] - ref).max())
    if err > tol:
        raise AssertionError(f"served probs differ from the plain path by "
                             f"{err} (gate {tol})")
    for n in requests[:2]:
        # the same rows in another request: equal within f32 rounding
        assert np.abs(served[n] - served[n3][:n]).max() <= 1e-6, n
    out = {"phase": label, "model": eng.model.name, "batch": B,
           "table_shape": list(state.table.shape),
           "table_dtype": str(state.table.dtype),
           "table_gb": state.table.numel() * state.table.element_size()
           / 1e9, "requests": list(requests), "max_abs_err_vs_plain": err,
           "gate": tol, "predict_ms_median": statistics.median(lat),
           "predict_ms_p90": float(np.percentile(lat, 90)),
           "examples_per_s": ex_s, "throughput_batches": nb,
           "evaluate": ev, "evaluate_batches": 64, "evaluate_s": eval_s,
           "launches": launches, "predict_profile": profile,
           "eval_step_host_waits": waits, "captured_vs_uncaptured": captured,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    return out


def phase_checkpoint() -> None:
    """save_checkpoint -> load_scorer -> identical scores, at 4,096 rows
    (a full-width save would write 8.6 GB); then the same checkpoint
    through the entry point `python -m herald_tpu_torch.serve`."""
    rows = 4096
    cfg = HeraldConfig(model="wdl_criteo", batch_size=BATCH,
                       embedding_dim=EMB, table_dtype=torch.bfloat16)
    eng = Engine(cfg, table_rows=rows, device="cuda")
    state = eng.init_state(1)
    spec = eng.model.spec
    dense, sparse, _ = synthetic_ctr_data(spec, 300, seed=2, num_rows=rows)
    want = Scorer(eng, state).score(dense, sparse)
    build_dir = build.BUILD_DIR
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        ckpt = str(Path(tmp) / "ckpt")
        save_checkpoint(state, ckpt)
        cfg_path = Path(tmp) / "config.json"
        cfg_path.write_text(cfg.to_json())
        loaded = load_scorer(ckpt, HeraldConfig.from_json(cfg_path.read_text()),
                             table_rows=rows, device="cuda")
        assert torch.equal(loaded.state.table, state.table)
        got = loaded.score(dense, sparse)
        if not np.array_equal(got, want):
            raise AssertionError("restored scorer differs: max "
                                 f"{np.abs(got - want).max()}")
        cli = _served_by_entry_point(ckpt, cfg_path, rows, dense, sparse)
        if not np.array_equal(cli, want):
            raise AssertionError("entry point differs: max "
                                 f"{np.abs(cli - want).max()}")
    emit({"phase": "checkpoint", "rows": rows, "emb": EMB,
          "requests": len(sparse), "identical": True,
          "entry_point": "python -m herald_tpu_torch.serve"})


def _stage(dense, sparse, labels, lo, k, batch=BATCH):
    """k batches from row lo, on the card as [k, batch, ...] tensors (the
    input pipeline's job; bench.py stages the same way)."""
    n = k * batch
    return tuple(torch.as_tensor(a[lo:lo + n].astype(dt).reshape(
        k, batch, -1), device="cuda")
        for a, dt in ((dense, np.float32), (sparse, np.int32),
                      (labels, np.float32)))


def reference_train_step(eng: Engine, state: TrainState, d, s, y,
                         apply=None):
    """The engine's SGD step through the route it replaced (the unique
    rows, `[inv]`, widen; `-lr * g`, then K2) with K1, K2 and K3 replaced
    by their plain versions and the tower by `apply` (default: the
    model's own); K3's
    plain version runs on the host, where `index_add_` adds in position
    order, the kernel's order for ids of at most 32 positions (it adds
    longer segments in pieces of 32)."""
    apply = apply or eng.model.apply
    step = state.step + 1
    B, F = s.shape
    uniq, inv = torch.unique(s.reshape(-1), sorted=True, return_inverse=True)
    emb = embedding_gather_ref(state.table, uniq)[inv].reshape(
        B, F, eng.width).float().requires_grad_(True)
    params = {k: v.detach().requires_grad_(True)
              for k, v in state.dense.items()}
    loss = bce_with_logits(apply(params, emb, d), y)
    grads = torch.autograd.grad(loss, [*params.values(), emb])
    dense, dense_slots = eng.dense_opt.apply_dense(
        state.dense, dict(zip(params, grads[:-1])), state.dense_slots, step,
        lr=eng._lr_fn(step))
    g_uniq = hot_onehot_push_ref(inv.cpu(), grads[-1].reshape(
        -1, eng.width).cpu(), uniq.numel()).to(state.table.device)
    rows_scatter_add_ref(state.table, uniq, -eng._elr_fn(step) * g_uniq)
    return TrainState(state.table, state.table_slots, dense, dense_slots,
                      step), loss.detach()


def _row_sums(table: torch.Tensor) -> torch.Tensor:
    """Per row, the sum of its elements' bit patterns (int64), a chunk of
    rows at a time: a fingerprint that any change of a row's bits moves
    but for collisions, without a second copy of the table."""
    words = table.view(torch.int16) if table.element_size() == 2 \
        else table.view(torch.int32)
    out = torch.empty(table.shape[0], dtype=torch.int64, device=table.device)
    step = 1 << 20
    for lo in range(0, table.shape[0], step):
        out[lo:lo + step] = words[lo:lo + step].to(torch.int64).sum(dim=1)
    return out


def phase_train(eng: Engine, state: TrainState, label="train", K=64,
                plain_apply=None, per_step=None) -> dict:
    """The main training path at full width: a warm-up chunk, then three
    timed chunks of K steps through Engine.train_epoch, each ended by a
    host readback of its last loss; `per_step` launches of each kernel
    every step (default: one K1, K2, K3 and dedup). Then a profile of 20 steps
    through train_epoch (device busy within BUSY_GATE of run B), 10 steps
    whose host waits are counted (none), and 8 steps held against the
    plain-kernel reference: the rows the 8 steps touch are copied into a
    compact table that the reference updates through remapped ids, and
    the other rows of the engine's table must keep their bits (row
    fingerprints before and after). Gates: each loss within 1e-5 of its
    value (relative), touched rows within one bf16 ulp, dense params
    within 1e-5. The same 8 steps run on another compact copy through
    the engine built with cuda_graphs=False: losses, rows, dense params
    and launches equal to the captured steps', bit for bit."""
    per_step = per_step or {"embedding_gather": 1, "hot_onehot_push": 1,
                            "rows_scatter_add": 1, "unique_fill": 1}
    B = eng.cfg.batch_size
    spec = eng.model.spec
    dense, sparse, labels = synthetic_ctr_data(spec, 2 * K * B, seed=0,
                                               num_rows=FULL_ROWS)
    chunks = [_stage(dense, sparse, labels, 0, K, B),
              _stage(dense, sparse, labels, K * B, K, B)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in KERNELS.values():
        kern.launches = 0
    state, stats = eng.train_epoch(state, *chunks[0], steps=K)   # warm-up
    float(stats["loss"][-1])
    times, losses = [], [stats["loss"]]
    for c in (1, 0, 1):
        t0 = time.perf_counter()
        state, stats = eng.train_epoch(state, *chunks[c], steps=K)
        float(stats["loss"][-1])
        times.append(time.perf_counter() - t0)
        losses.append(stats["loss"])
    launches = {name: kern.launches for name, kern in KERNELS.items()}
    if launches != _want(per_step, 4 * K):
        raise AssertionError(f"the {label} path launched {launches}; "
                             f"expected {_want(per_step, 4 * K)}")
    losses = torch.cat(losses).cpu()
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError("non-finite training loss")
    peak = torch.cuda.max_memory_allocated() / 1e9
    med = statistics.median(times)

    # the main path's steps profiled: train_epoch over chunks of 10
    d0, s0, y0 = chunks[0]
    holder, per_chunk = [state], 10

    def chunk(i):
        j = (i * per_chunk) % (K - per_chunk)
        holder[0], _ = eng.train_epoch(
            holder[0], d0[j:j + per_chunk], s0[j:j + per_chunk],
            y0[j:j + per_chunk], steps=per_chunk)

    busy, per, host, _ = device_profile(chunk, 2)
    if busy is not None:
        busy /= per_chunk
    host /= per_chunk
    per = {k: v / per_chunk for k, v in per.items()}
    waits, sites = _count_host_waits(lambda: chunk(2))
    waits /= per_chunk
    _no_waits(label, waits, sites)
    state = holder[0]
    profile = {"device_busy_ms": busy, "host_ms_profiled": host,
               "steps": 2 * per_chunk, "through": "train_epoch",
               "device_idle_share": None if busy is None else 1 - busy / host,
               "hot_onehot_push_device_ms": _k3_ms(per),
               "top_device_ms": _top(per),
               "busy_gate": _busy_gate(label, busy),
               "host_waits_per_step": waits, "host_wait_sites": sites}

    # 8 steps against the plain-kernel reference and, on a compact copy of
    # the rows they touch, against the same engine uncaptured, from one
    # state
    d1, s1, y1 = chunks[1]
    touched = torch.unique(s1[:8].reshape(-1).long())
    before = _row_sums(state.table)
    ref = TrainState(state.table[touched].clone(), {},
                     {k: v.clone() for k, v in state.dense.items()},
                     {k: {} for k in state.dense}, state.step.clone())
    twin = _tree(lambda t: t.clone(), ref)
    eager = (Engine(eng.cfg, model=eng.model, table_rows=eng.num_rows,
                    device=DEVICE, cuda_graphs=False) if GRAPHS else None)
    got_l, want_l, twin_l, got_t = [], [], [], []
    tally, tally_e = {}, {}
    for i in range(8):
        state, st = _tallied(tally, lambda: eng.train_step(
            state, d1[i], s1[i], y1[i]))
        local = torch.searchsorted(touched, s1[i].long()).to(torch.int32)
        ref, loss = reference_train_step(eng, ref, d1[i], local, y1[i],
                                         plain_apply)
        if eager is not None:
            twin, tst = _tallied(tally_e, lambda: eager.train_step(
                twin, d1[i], local, y1[i]))
            twin_l.append(tst["loss"])
            got_t.append(st["loss"])
        got_l.append(float(st["loss"]))
        want_l.append(float(loss))
    captured = None
    if eager is not None:
        captured = {"steps": 8, "touched_rows": int(touched.numel()),
                    "losses_differ": _differ(got_t, twin_l),
                    "state_differ": _differ(
                        TrainState(state.table[touched], state.table_slots,
                                   state.dense, state.dense_slots,
                                   state.step), twin),
                    "launches": tally, "uncaptured_launches": tally_e,
                    "graphs": eng.graphs.captures}
        if captured["losses_differ"] or captured["state_differ"]:
            raise AssertionError(f"captured steps differ from uncaptured: "
                                 f"{captured}")
        _same_launches(captured)
    del twin
    differ = before != _row_sums(state.table)
    differ[touched] = False
    if bool(differ.any()):
        raise AssertionError(f"{int(differ.sum())} rows no step touched "
                             f"changed")
    a, b = state.table[touched].float(), ref.table.float()
    row_err = float((a - b).abs().max())
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(got_l, want_l))
    dense_err = max(float((state.dense[k] - ref.dense[k]).abs().max())
                    for k in ref.dense)
    if loss_err > 1e-5 or dense_err > 1e-5 \
            or not torch.allclose(a, b, rtol=2 ** -7, atol=0):
        raise AssertionError(f"training differs from the plain-kernel "
                             f"reference: loss {loss_err}, rows {row_err}, "
                             f"dense {dense_err}")
    identical = bool(torch.equal(state.table[touched], ref.table))
    del ref, a, b, differ, before
    out = {"phase": label, "model": eng.model.name, "batch": B,
           "table_shape": list(state.table.shape),
           "table_dtype": str(state.table.dtype), "optimizer": "sgd",
           "lr": eng.cfg.learning_rate, "steps_timed": 3 * K,
           "chunk_s": times, "train_examples_per_s": K * B / med,
           "step_ms_median": med / K * 1e3, "launches": launches,
           "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
           "peak_mem_gb": peak, "step_profile": profile,
           "reference_steps": 8, "reference_loss_max_rel_err": loss_err,
           "reference_row_max_err": row_err,
           "reference_dense_max_err": dense_err,
           "reference_touched_rows_identical": identical,
           "touched_rows": int(touched.numel()),
           "captured_vs_uncaptured": captured}
    emit(out)
    return out


def phase_train_adam() -> dict:
    """Adam on the table at full width (table + two bf16 slots, 25.9 GB)
    through the dedup path: K3 sums the grads, K1 reads the rows and
    slots, index_copy_ writes them back; no K2. 8 warm-up steps, 8 counted
    steps held bit for bit against the same engine uncaptured on a compact
    copy of the rows they touch, then 8 steps whose host waits are
    counted."""
    cfg = HeraldConfig(model="wdl_criteo", batch_size=BATCH,
                       embedding_dim=EMB, table_dtype=torch.bfloat16,
                       optimizer="adam", learning_rate=0.01)
    eng = Engine(cfg, table_rows=FULL_ROWS, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    state = eng.init_state(0)
    dense, sparse, labels = synthetic_ctr_data(eng.model.spec, 24 * BATCH,
                                               seed=0, num_rows=FULL_ROWS)
    chunk = _stage(dense, sparse, labels, 0, 24)
    state, _ = eng.train_epoch(state, *[c[:8] for c in chunk], steps=8)
    d, s, y = (c[8:16] for c in chunk)
    touched = torch.unique(s.reshape(-1).long())
    twin = TrainState(state.table[touched].clone(),
                      {k: v[touched].clone()
                       for k, v in state.table_slots.items()},
                      *_tree(lambda t: t.clone(), state)[2:])
    local = torch.searchsorted(touched, s.long()).to(torch.int32)
    torch.cuda.synchronize()
    for kern in KERNELS.values():
        kern.launches = 0
    t0 = time.perf_counter()
    state, stats = eng.train_epoch(state, d, s, y, steps=8)
    losses = stats["loss"].cpu()
    step_ms = (time.perf_counter() - t0) / 8 * 1e3
    launches = {name: kern.launches for name, kern in KERNELS.items()}
    want = _want({"embedding_gather": 4, "hot_onehot_push": 1,
                  "unique_fill": 1}, 8)
    if launches != want:
        raise AssertionError(f"the adam path launched {launches}, expected "
                             f"{want}")
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError("non-finite adam loss")
    eager = Engine(cfg, table_rows=FULL_ROWS, device=DEVICE,
                   cuda_graphs=False)
    tally_e = {}
    twin, tstats = _tallied(tally_e, lambda: eager.train_epoch(
        twin, d, local, y, steps=8))
    captured = {"steps": 8, "touched_rows": int(touched.numel()),
                "launches": {k: n for k, n in launches.items() if n},
                "uncaptured_launches": {k: n for k, n in tally_e.items()
                                        if n},
                "losses_differ": _differ([stats["loss"]], [tstats["loss"]]),
                "state_differ": _differ(TrainState(
                    state.table[touched],
                    {k: v[touched] for k, v in state.table_slots.items()},
                    state.dense, state.dense_slots, state.step), twin),
                "graphs": eng.graphs.captures}
    del twin
    if captured["losses_differ"] or captured["state_differ"]:
        raise AssertionError(f"captured adam steps differ from uncaptured: "
                             f"{captured}")
    _same_launches(captured)
    holder = [state]

    def more():
        holder[0], _ = eng.train_epoch(holder[0], *[c[16:] for c in chunk],
                                       steps=8)

    waits, sites = _count_host_waits(more)
    _no_waits("train:adam", waits, sites)
    state = holder[0]
    out = {"phase": "train:adam", "slots": sorted(state.table_slots),
           "state_gb": 3 * state.table.numel() * 2 / 1e9, "steps": 24,
           "step_ms": step_ms, "launches_last_8_steps": launches,
           "losses": losses.tolist(), "captured_vs_uncaptured": captured,
           "host_waits_per_step": waits / 8, "host_wait_sites": sites,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    return out


def _run(argv, timeout=600):
    """Run an entry point from the checkout; its output on failure."""
    proc = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(argv[:1])} exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    return proc.stdout


def _report(stdout: str) -> dict:
    """The launcher's report: the indented JSON object that ends its
    output (from its first line, or from the start of the output)."""
    return json.loads(stdout[stdout.rfind("\n{\n") + 1:])


def phase_launch() -> dict:
    """The entry point, in subprocesses: a full-width run; at 4,096 rows a
    run stopped at --max-steps and resumed with --resume, which must give
    the uninterrupted run's final table bit for bit; then that checkpoint
    served by `python -m herald_tpu_torch.serve`, scoring equal to
    Engine.predict on the restored state."""
    launch = ["herald_tpu_torch.launch", "--model", "wdl_criteo",
              "--bf16-table"]
    t0 = time.perf_counter()
    full = _report(_run(launch + ["--rows", str(FULL_ROWS), "--samples",
                                  "65536", "--scan-steps", "32",
                                  "--max-steps", "96"]))
    full_s = time.perf_counter() - t0
    if full["steps"] != 96 or not np.isfinite(full["train_loss_last"]) \
            or not 0.0 <= full["val_auc"] <= 1.0:
        raise AssertionError(f"full-width launch report: {full}")
    rows = 4096
    small = launch + ["--rows", str(rows), "--samples", "8192",
                      "--scan-steps", "8", "--nepoch", "2", "--lr", "0.5"]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        whole = _report(_run(small + ["--ckpt", str(tmp / "whole"),
                                      "--save-config", str(tmp / "cfg.json")]))
        part = _report(_run(small + ["--ckpt", str(tmp / "part"),
                                     "--ckpt-every", "8", "--max-steps",
                                     "20"]))
        rest = _report(_run(small + ["--resume", str(tmp / "part"), "--ckpt",
                                     str(tmp / "rest")]))
        if part["steps"] != 20 or part["steps"] + rest["steps"] != \
                whole["steps"]:
            raise AssertionError(f"steps {part['steps']} + {rest['steps']} "
                                 f"!= {whole['steps']}")
        a = load_checkpoint(str(tmp / "whole"), "cuda")
        b = load_checkpoint(str(tmp / "rest"), "cuda")
        if int(a.step) != whole["steps"] or not torch.equal(a.table,
                                                            b.table) \
                or not all(torch.equal(a.dense[k], b.dense[k])
                           for k in a.dense):
            raise AssertionError("the resumed run's final state differs "
                                 "from the uninterrupted run's")
        cfg = HeraldConfig.from_json((tmp / "cfg.json").read_text())
        eng = Engine(cfg, table_rows=rows, device="cuda")
        dense, sparse, _ = synthetic_ctr_data(eng.model.spec, BATCH, seed=3,
                                              num_rows=rows)
        want = eng.predict(a, dense, sparse).cpu().numpy()
        served = _served_by_entry_point(tmp / "whole", tmp / "cfg.json",
                                        rows, dense, sparse)
        if not np.array_equal(served, want):
            raise AssertionError(f"served scores differ from Engine.predict "
                                 f"by {np.abs(served - want).max()}")
    out = {"phase": "launch", "full_width": {
        k: full[k] for k in ("steps", "train_loss_last", "val_auc",
                             "val_acc", "examples_per_sec", "device")},
        "full_width_command_s": full_s, "rows_small": rows,
        "small_steps": whole["steps"], "resumed_at": part["steps"],
        "resume_bit_exact": True, "served_equal_predict": True,
        "served_requests": BATCH}
    emit(out)
    return out


# ----------------------------------------------------------------------
# the scheduled, cached engine (bench.py:113-250's configuration)
# ----------------------------------------------------------------------

SCHED_ITERS, SCHED_EPOCHS, PINNED = 256, 5, 4096
DEVICE = "cuda"


def _tree(fn, state):
    """A state of the same NamedTuple type with fn applied to every
    tensor (dicts of tensors kept as dicts)."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return fn(x)
    return type(state)(*(conv(f) for f in state))


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _sched_setup(pinned: int, model="wdl_criteo", batch=BATCH, emb=EMB,
                 iters=SCHED_ITERS):
    """bench_scheduled's configuration at full width (or `model` at its
    own), with the program widths sized from a host probe pass
    (bench.py:130-151): data, config, engine. With a pinned tier the ids
    are frequency-remapped first, as the launcher does."""
    cfg = HeraldConfig(model=model, batch_size=batch, embedding_dim=emb,
                       learning_rate=0.01, table_dtype=torch.bfloat16,
                       use_cache=True, use_scheduler=True,
                       cache_limit_ratio=0.1, pinned_rows=pinned)
    spec = DATASETS["criteo"]
    dense, sparse, labels = synthetic_ctr_data(
        spec, batch * iters, seed=0, num_rows=FULL_ROWS)
    if pinned:
        sparse, _ = frequency_remap(sparse, FULL_ROWS)
    data = (dense.astype(np.float32), sparse.astype(np.int32),
            labels.astype(np.float32))
    t0 = time.perf_counter()
    probe = CachedEngine(cfg, table_rows=FULL_ROWS,
                         device=DEVICE).make_planner(sparse, epochs=1)
    steps, _ = profile_planned_traffic(probe, sparse, 1)
    probe.close()
    prof = TrafficProfile.from_steps(steps)
    cfg.sched_flush_slots = prof.flush_slots()
    cfg.sched_unique_slots = prof.unique_slots()
    eng = CachedEngine(cfg, table_rows=FULL_ROWS, device=DEVICE)
    return cfg, eng, data, time.perf_counter() - t0


def _expected_launches(tape, steps: int, pinned: bool, fm=False) -> dict:
    """Each kernel's launches over the first `steps` steps of a program
    stream: per step one K1 read of the cache slots and one K3 sum of the
    grads; one K1 pull on a step with pulls or prefetches; two K1 reads
    (cache rows, table rows; SGD keeps no table slots) on a step with
    flushes; with a pinned tier one K4 read and a second K3 sum; for an
    FM model one K5 forward and one K5 backward per step; no dedup (the
    planner's programs carry each step's unique ids and inverse). The
    pinned read is K4's in-place add, none of its gather, but in a
    checkout from before the add form (an A/B's parent under --root)."""
    fids, pulls, pfids = (np.asarray(tape[k][:steps])
                          for k in ("fids", "pulls", "pfids"))
    has_flush = (fids >= 0).any(axis=1)
    has_pull = pulls.any(axis=1) | (pfids >= 0).any(axis=1)
    read = ("hot_onehot_gather_add_" if "hot_onehot_gather_add_" in KERNELS
            else "hot_onehot_gather")
    want = {"embedding_gather": int(steps + has_pull.sum()
                                    + 2 * has_flush.sum()),
            "hot_onehot_gather": 0, "hot_onehot_gather_add_": 0,
            "hot_onehot_push": steps * (2 if pinned else 1),
            "rows_scatter_add": 0,
            "fm_second_order": steps if fm else 0,
            "fm_second_order_backward": steps if fm else 0,
            "unique_fill": 0, "gather_pool_rows": 0,
            "steps_with_flush": int(has_flush.sum()),
            "steps_with_pull": int(has_pull.sum())}
    want[read] = steps if pinned else 0
    return want


def _check_launches(label: str, want: dict) -> dict:
    got = {name: k.launches for name, k in KERNELS.items()}
    if got != {k: want[k] for k in KERNELS}:
        raise AssertionError(f"{label} launched {got}, expected {want}")
    return got


def _count_host_waits(fn):
    """(count, sites) of the synchronizing CUDA calls PyTorch makes while
    fn runs (its sync debug mode warns on each): the host's waits for the
    card, and where up to five distinct ones came from."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the notice that the mode is a prototype is not a wait
    waits = [w for w in caught if "synchroniz" in str(w.message)
             and "prototype" not in str(w.message)]
    sites = sorted({f"{Path(w.filename).name}:{w.lineno}: "
                    f"{str(w.message)[:100]}" for w in waits})
    return len(waits), sites[:5]


def _no_waits(label: str, waits: int, sites) -> None:
    """Raise if a captured path's steps waited for the card."""
    if GRAPHS and waits:
        raise AssertionError(f"the {label} steps waited for the card {waits} "
                             f"times: {sites}")


def _busy_gate(label: str, busy) -> dict:
    """Raise unless a captured path's device busy a step (None: the
    profiler lost it) is within BUSY_GATE of run B's; the ratio."""
    ref = RUN_B_BUSY_MS[label]
    out = {"run_b_ms": ref, "ratio": None if busy is None else busy / ref,
           "gate": BUSY_GATE}
    if GRAPHS and (busy is None or busy > BUSY_GATE * ref):
        raise AssertionError(f"the {label} step's device busy {busy} ms is "
                             f"not within {BUSY_GATE} of run B's {ref} ms")
    return out


def _tallied(tally: dict, fn):
    """fn(), its kernel launches added into `tally`."""
    before = _launch_counts()
    out = fn()
    for k, n in _launch_counts().items():
        tally[k] = tally.get(k, 0) + n - before[k]
    return out


def _same_launches(captured: dict) -> None:
    """Raise unless the captured steps launched what the uncaptured ones
    did (`launches` and `uncaptured_launches` of a twin check)."""
    if captured["launches"] != captured["uncaptured_launches"]:
        raise AssertionError(f"captured steps launched "
                             f"{captured['launches']}, uncaptured "
                             f"{captured['uncaptured_launches']}")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def _differ(a, b) -> list:
    """The leaves (paths) of two states, or two lists of tensors, whose
    bits differ."""
    from herald_tpu_torch.train.graphs import leaves
    la, lb = leaves(tuple(a)), leaves(tuple(b))
    if la.keys() != lb.keys():
        return ["structure"]
    return [str(p) for p in la if not torch.equal(_bits(la[p]),
                                                  _bits(lb[p]))]


def _profile_chunks(run, n: int, steps_per_chunk: int,
                    tries: int = 3) -> dict:
    """Device busy, host time and the top device items per step over n
    chunks run(0..n-1), one profiler session, taken again over the same
    chunks, up to `tries` in all, while it saw no device activity or lost
    the record of a measured launch. A retake runs the chunks' programs
    again on the state they left (the same shapes and launches; nothing
    after a profile compares the state's values with a reference). Where
    none passed, busy is "not measured", None."""
    torch.cuda.synchronize()
    steps = n * steps_per_chunk
    for n_try in range(1, tries + 1):
        prof, host, lost = _session(run, n)
        per, _ = _device_items(prof, steps)
        if per and not lost:
            break
    host /= steps_per_chunk
    busy = sum(per.values()) if per and not lost else None
    return {"steps": steps, "device_busy_ms": busy,
            "host_ms_profiled": host, "launches_lost": len(lost),
            "sessions": n_try,
            "device_idle_share": None if busy is None else 1 - busy / host,
            "hot_onehot_push_device_ms": _k3_ms(per) if busy else None,
            "pinned_read_kernel_ms": {k: v for k, v in per.items()
                                      if HOT_ADD in k or HOT_GATHER in k},
            "copies_ms": {k: v for k, v in per.items()
                          if k.startswith("Memcpy")},
            "top_device_ms": _top(per)}


def _epochs_timed(run_epoch, epochs: int):
    """Wall time of each epoch, each ended by a readback of its last loss
    (bench.py:236-239)."""
    times, losses = [], []
    for e in range(epochs):
        t0 = time.perf_counter()
        stats = run_epoch(e)
        losses.append(float(stats["loss"][-1]))
        times.append(time.perf_counter() - t0)
    return times, losses


def _eval_after_sync(eng, state) -> dict:
    dense, sparse, labels = synthetic_ctr_data(
        DATASETS["criteo"], 32 * BATCH, seed=1, num_rows=FULL_ROWS)
    with warnings.catch_warnings():
        warnings.simplefilter("error")     # synced: no unsynced warning
        ev = eng.evaluate(state, dense, sparse, labels)
    if not (np.isfinite(ev["auc"]) and np.isfinite(ev["acc"])):
        raise AssertionError(f"evaluate gave {ev}")
    return ev


def _tape_run(eng, data, tmp: Path, iters: int, epochs: int,
              fm=False) -> dict:
    """Tape mode of a scheduled phase: a plan tape of epochs + 1 epochs
    recorded with plan_cache, every chunk of 32 staged ahead in direct
    feed, `epochs` counted epochs timed to a readback of their last loss
    (bench.py:236-239; the best warm epoch is the rate), then one more
    epoch whose first chunks count the host's waits for the card (sync
    debug mode) and whose other chunks are profiled; then sync_cache and
    evaluate."""
    dense, sparse, labels = data
    total, counted = (epochs + 1) * iters, epochs * iters
    per_epoch = iters // 32
    batch = eng.cfg.batch_size
    out = {}
    t0 = time.perf_counter()
    planner = plan_cache(eng, sparse, str(tmp / "tape"), epochs=epochs + 1)
    out["tape_record_s"] = time.perf_counter() - t0
    tape = {k: np.load(tmp / "tape" / f"{k}.npy", mmap_mode="r")
            for k in ("fids", "pulls", "pfids")}
    want = _expected_launches(tape, counted, pinned=False, fm=fm)
    torch.cuda.reset_peak_memory_stats()
    holder = [eng.init_cached_state(0)]
    t0 = time.perf_counter()
    staged = eng.stage_program_chunks(planner, 32, raw=data)
    torch.cuda.synchronize()
    out["tape_stage_s"] = time.perf_counter() - t0
    assert len(staged) == total // 32, len(staged)

    def run_chunk(i):
        holder[0], stats = eng.train_epoch_staged(holder[0], staged[i])
        return stats

    def tape_epoch(e):
        pending = [run_chunk(e * per_epoch + c) for c in range(per_epoch)]
        return {"loss": torch.cat([p["loss"] for p in pending]),
                "overflow": torch.cat([p["overflow"] for p in pending])}

    for k in KERNELS.values():
        k.launches = 0
    epochs_out = []
    times, _ = _epochs_timed(
        lambda e: epochs_out.append(tape_epoch(e)) or epochs_out[-1], epochs)
    launches = _check_launches(f"the {eng.model.name} scheduled path "
                               f"(tape)", want)
    overflow = int(sum(int(o["overflow"].sum()) for o in epochs_out))
    losses = torch.cat([o["loss"] for o in epochs_out]).cpu()
    if overflow or not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"tape run: overflow {overflow}, finite "
                             f"{bool(torch.isfinite(losses).all())}")
    warm = times[2:] if eng.nopull_chunks else times[1:]
    chunks = {"full": epochs * per_epoch - eng.noflush_chunks,
              "flush_free": eng.noflush_chunks - eng.nopull_chunks,
              "pull_free": eng.nopull_chunks}
    base, n_wait = epochs * per_epoch, max(1, per_epoch // 4)
    waits, sites = _count_host_waits(lambda: [run_chunk(base + c)
                                              for c in range(n_wait)])
    profile = _profile_chunks(lambda i: run_chunk(base + n_wait + i),
                              per_epoch - n_wait, 32)
    profile["host_waits_per_step"] = waits / (32 * n_wait)
    profile["host_wait_sites"] = sites
    label = "scheduled:dfm" if fm else "scheduled"
    _no_waits(f"{label} (tape)", waits, sites)
    profile["busy_gate"] = _busy_gate(label, profile["device_busy_ms"])
    peak = torch.cuda.max_memory_allocated() / 1e9
    state = eng.sync_cache(holder[0], planner)
    del holder, staged, epochs_out
    out.update({
        "scheduled_examples_per_s": batch * iters / min(warm),
        "epoch_examples_per_s": [batch * iters / t for t in times],
        "epoch_s": times, "step_ms": min(warm) / iters * 1e3,
        "chunks_tape": chunks, "launches_tape": launches,
        "expected_tape": want, "overflow": overflow,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "cache": cache_report(planner, total, eng.ids_per_worker),
        "step_profile": profile, "peak_mem_gb": peak,
        "evaluate": _eval_after_sync(eng, state)})
    planner.close()
    return out


def phase_scheduled() -> dict:
    """The scheduled engine at bench_scheduled's full width, two modes.
    Tape: `_tape_run`. Live: the planner in situ, stage_dataset (index
    feed), chunks of 64, a queue of 256, SCHED_EPOCHS timed epochs (the
    counted main path) and one more that drains the stream. Then
    sync_cache and evaluate."""
    cfg, eng, (dense, sparse, labels), probe_s = _sched_setup(0)
    total = (SCHED_EPOCHS + 1) * SCHED_ITERS
    out = {"phase": "scheduled", "probe_s": probe_s,
           "cache_rows": eng.cache_rows, "U_cap": eng.U_cap,
           "F_cap": eng.F_cap, "P_cap": eng.P_cap,
           "cache_gb": eng.cache_rows * 2 * eng.width * 4 / 1e9}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        # --- tape mode ---
        out.update(_tape_run(eng, (dense, sparse, labels), Path(tmp),
                             SCHED_ITERS, SCHED_EPOCHS))
        want = out["expected_tape"]
        _free()

        # --- live mode: the same stream, planned in situ ---
        live_cfg = HeraldConfig(**{**cfg.__dict__, "sched_queue_size": 256})
        eng_l = CachedEngine(live_cfg, table_rows=FULL_ROWS,
                             device=DEVICE)
        planner = eng_l.make_planner(sparse, epochs=SCHED_EPOCHS + 1)
        state = eng_l.init_cached_state(0)
        dev = eng_l.stage_dataset(dense, sparse, labels)
        holder = [state]

        def live_epoch(e):
            outs = []
            for _ in range(SCHED_ITERS // 64):
                holder[0], stats = eng_l.train_epoch_cached(
                    holder[0], planner, None, None, None, steps=64,
                    device_data=dev)
                outs.append(stats)
            return {"loss": torch.cat([o["loss"] for o in outs]),
                    "overflow": torch.cat([o["overflow"] for o in outs])}

        for k in KERNELS.values():
            k.launches = 0
        ltimes, _ = _epochs_timed(live_epoch, SCHED_EPOCHS)
        launches_l = _check_launches("the scheduled path (live)", want)
        lwarm = ltimes[2:] if eng_l.nopull_chunks else ltimes[1:]
        chunks_live = {"full": SCHED_EPOCHS * 4 - eng_l.noflush_chunks,
                       "flush_free": eng_l.noflush_chunks
                       - eng_l.nopull_chunks,
                       "pull_free": eng_l.nopull_chunks}
        lwaits, lsites = _count_host_waits(
            lambda: live_epoch(SCHED_EPOCHS))
        _no_waits("scheduled (live)", lwaits, lsites)
        state = eng_l.sync_cache(holder[0], planner)
        out.update({
            "scheduled_live_examples_per_s":
                BATCH * SCHED_ITERS / min(lwarm),
            "live_epoch_examples_per_s": [BATCH * SCHED_ITERS / t
                                          for t in ltimes],
            "live_step_ms": min(lwarm) / SCHED_ITERS * 1e3,
            "live_host_waits_per_step": lwaits / SCHED_ITERS,
            "live_host_wait_sites": lsites,
            "chunks_live": chunks_live, "launches_live": launches_l,
            "live_cache": cache_report(planner, total, eng_l.ids_per_worker),
            "live_evaluate": _eval_after_sync(eng_l, state)})
        planner.close()
        del state, holder, dev
        _free()
    emit(out)
    phase_scheduled_memo(cfg, (dense, sparse, labels), want)
    return out


# scheduled:memo, written before its first chip run (NVIDIA H100 80GB
# HBM3, 700.00 W in every earlier run): [low, high]. A live step of
# phase_scheduled ran 0.30-0.31 ms (820K-836K examples/s) in earlier
# runs with 0.175 ms of device work: the host sets the pace. The memo skips the
# copy (about 0.014 ms of device time a step, 0.005 of host) and adds a
# full compare of the chunk's bytes (a hit) or a host copy of them (a
# miss), each about what the pack costs
MEMO_PREDICTED = {
    "live_examples_per_s": {"off": [650e3, 850e3], "on": [620e3, 850e3]},
    # written after the first parent-and-change run of this phase, before
    # the alone leg's first run: the split of a leg that runs alone, its
    # planner with no other leg's epoch to plan ahead in (the parent's
    # memo-off leg, alone, popped 0.114-0.152 ms a step against
    # 0.027-0.046 in turns)
    "alone_pop_chunk_ms_per_step": [0.08, 0.18],
    "on_over_off_hit_epochs": [0.95, 1.05],
    "busy_ms_per_step": {"off": [0.17, 0.20], "on": [0.155, 0.19]},
    "host_ms_per_step_off": {"pop_chunk": [0.005, 0.05],
                             "chunk_program": [0.10, 0.25],
                             "pack": [0.03, 0.08],
                             "copy_issue": [0.0, 0.005],
                             "dispatch": [0.04, 0.09]},
    "htod_ms_per_step_off": [0.008, 0.02],
    "first_epoch_with_hits": 2}
MEMO_PARTS = ("pop_chunk", "chunk_program", "pack", "copy_issue",
              "memo_hit", "memo_miss", "dispatch")


def _timed_split(eng, planner, acc: dict) -> None:
    """Wrap the staging steps of `eng` and `planner` on these instances
    so that each call adds its host seconds to acc[part] (MEMO_PARTS):
    the planner's pop, `_chunk_program`, the pack into pinned memory
    (`_host_feed`), the copy's issue (the memo-off `_memo_stage`, or a
    tree without the memo's `_to_device` less its pack), the memo's
    lookup and compare on a hit and its staging on a miss, and the steps'
    dispatch (`train_epoch_staged`, which also notes the chunk's bytes)."""
    def wrap(obj, name, part):
        fn = getattr(obj, name)

        def timed(*a, **k):
            hits = getattr(eng, "memo_hits", 0)
            memo = getattr(eng, "_memo_on", False)
            pack = acc.get("pack", 0.0)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            dt = time.perf_counter() - t0
            key = part
            if name == "_memo_stage" and memo:
                key = "memo_hit" if eng.memo_hits > hits else "memo_miss"
            elif name == "_to_device":      # its pack is counted apart
                dt -= acc.get("pack", 0.0) - pack
            elif name == "train_epoch_staged":
                acc["chunk_bytes"] = a[1].packed.numel()
                acc["row_bytes"] = a[1].packed.shape[-1]
            acc[key] = acc.get(key, 0.0) + dt
            return out
        setattr(obj, name, timed)
    wrap(planner, "pop_chunk", "pop_chunk")
    wrap(eng, "_chunk_program", "chunk_program")
    wrap(eng, "_host_feed", "pack")
    wrap(eng, "train_epoch_staged", "dispatch")
    if hasattr(eng, "_memo_stage"):
        wrap(eng, "_memo_stage", "copy_issue")
    else:
        wrap(eng, "_to_device", "copy_issue")


def _fingerprint(t: torch.Tensor) -> int:
    """The sum of a tensor's bits as integers of its element size."""
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return int(t.reshape(-1).view(bits[t.element_size()]).sum(
        dtype=torch.int64))


def _memo_leg(cfg, data, memo: bool, **kw) -> dict:
    """One live engine of scheduled:memo at full width (`kw` overrides
    its config): its planner over SCHED_EPOCHS + 1 epochs, its state from
    seed 0, the dataset on the card, its staging timed (`_timed_split`)."""
    dense, sparse, labels = data
    c = HeraldConfig(**{**cfg.__dict__, "sched_queue_size": 256,
                        "sched_chunk_memo": memo, **kw})
    eng = CachedEngine(c, table_rows=FULL_ROWS, device=DEVICE)
    planner = eng.make_planner(sparse, epochs=SCHED_EPOCHS + 1)
    acc = {}
    _timed_split(eng, planner, acc)
    return {"eng": eng, "planner": planner, "acc": acc,
            "state": [eng.init_cached_state(0)],
            "dev": eng.stage_dataset(dense, sparse, labels),
            "losses": [], "epoch_s": [], "hits": [], "split": []}


def _memo_chunk(leg):
    """One chunk of 64 live steps of a leg: its stats (None at the end)."""
    leg["state"][0], stats = leg["eng"].train_epoch_cached(
        leg["state"][0], leg["planner"], None, None, None, steps=64,
        device_data=leg["dev"])
    return stats


def _memo_epoch(leg) -> None:
    """One epoch of a leg, ended by a readback of its last loss: its
    seconds, hits, losses and host split (ms, MEMO_PARTS and the rest)."""
    leg["acc"].clear()
    hits = getattr(leg["eng"], "memo_hits", 0)
    t0 = time.perf_counter()
    outs = [_memo_chunk(leg) for _ in range(SCHED_ITERS // 64)]
    float(outs[-1]["loss"][-1])
    dt = time.perf_counter() - t0
    leg["epoch_s"].append(dt)
    leg["hits"].append(getattr(leg["eng"], "memo_hits", 0) - hits)
    leg["losses"].append(torch.cat([o["loss"] for o in outs]))
    split = {p: leg["acc"].get(p, 0.0) * 1e3 for p in MEMO_PARTS}
    split["other"] = dt * 1e3 - sum(split.values())
    leg["split"].append(split)
    leg["chunk_bytes"] = leg["acc"].get("chunk_bytes")
    leg["row_bytes"] = leg["acc"].get("row_bytes")


def _memo_rates(leg) -> dict:
    """A leg's rates and its host split a step over its warm epochs (the
    third on)."""
    warm = leg["epoch_s"][2:]
    steps = SCHED_ITERS * len(warm)
    step_ms = sum(warm) * 1e3 / steps
    mean = {p: sum(sp[p] for sp in leg["split"][2:]) / steps
            for p in (*MEMO_PARTS, "other")}
    return {"live_examples_per_s": BATCH * SCHED_ITERS / min(warm),
            "epoch_examples_per_s": [BATCH * SCHED_ITERS / t
                                     for t in leg["epoch_s"]],
            "split_ms_epoch": leg["split"], "split_ms_per_step_warm": mean,
            "step_ms_warm": step_ms,
            "pop_and_program_share": (mean["pop_chunk"]
                                      + mean["chunk_program"]) / step_ms,
            "copy_issue_share": mean["copy_issue"] / step_ms,
            "chunk_bytes": leg["chunk_bytes"]}


def phase_scheduled_memo(cfg, data, want) -> dict:
    """scheduled:memo: the live planner at full width on phase_scheduled's
    stream (index feed, chunks of 64, a queue of 256). First memo off
    alone for SCHED_EPOCHS epochs, as a live run has it: each epoch's host
    time split into MEMO_PARTS (`_timed_split`), its rate. Then memo off
    and on, two more engines from one seed, SCHED_EPOCHS epochs each in
    turns (each planner then plans ahead while the other leg runs), each
    ended by a readback of its last loss: rates, splits, hits. Then one
    more epoch of each: its first chunk counts the host's waits for the
    card (0 required), one chunk is profiled (device busy a step, the
    HtoD copies), the rest drains the stream; sync_cache; memo on held
    against memo off bit for bit (losses, every leaf of the state; the
    table's and cache's bit sums printed), and the alone run's losses
    against both. Last, one more engine ships the full row
    (`sched_packed_wire` off: `inv` int32, every index) over the whole
    stream, its losses and state held bit for bit against memo off's,
    whose narrowed row the captured step widens. The counted epochs
    launch 3x the tape's launches. A tree without the memo (a parent
    under --root) runs memo off alone."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    memo = hasattr(CachedEngine, "_memo_stage")
    for k in KERNELS.values():
        k.launches = 0
    alone = _memo_leg(cfg, data, False)
    for _ in range(SCHED_EPOCHS):
        _memo_epoch(alone)
    out = {"phase": "scheduled:memo", "nvidia_smi": smi,
           "predicted": MEMO_PREDICTED, "epochs": SCHED_EPOCHS,
           "chunk_steps": 64, "alone": _memo_rates(alone)}
    modes = ("off", "on") if memo else ()
    legs = {"off": alone} if not memo else {}
    if memo:
        alone["planner"].close()
        alone_losses = alone["losses"]
        del alone
        _free()
        legs = {m: _memo_leg(cfg, data, m == "on") for m in modes}
        for _ in range(SCHED_EPOCHS):
            for m in modes:
                _memo_epoch(legs[m])
    out["launches"] = _check_launches("the scheduled path (memo)", {
        k: (1 + len(modes)) * want[k] for k in KERNELS})
    for m, leg in legs.items():
        eng = leg["eng"]
        waits, sites = _count_host_waits(lambda: _memo_chunk(leg))
        _no_waits(f"scheduled:memo ({m})", waits, sites)
        prof = _profile_chunks(lambda i: _memo_chunk(leg), 1, 64)
        while _memo_chunk(leg) is not None:
            pass
        htod = sum(v for k, v in prof["copies_ms"].items() if "HtoD" in k)
        out[m] = {
            **(_memo_rates(leg) if memo else {}),
            "memo_hits_per_epoch": leg["hits"],
            "memo_active": getattr(eng, "_memo_on", None),
            "memo_host_bytes": getattr(eng, "_memo_bytes", None),
            "memo_device_bytes": sum(
                c.packed.numel()
                for _, c in getattr(eng, "_chunk_memo", {}).values()),
            "host_waits_per_step": waits / 64, "host_wait_sites": sites,
            "device_busy_ms_per_step": prof["device_busy_ms"],
            "htod_ms_per_step": htod, "step_profile": prof,
            "staged_step_bytes": eng.staged_step_bytes()}
        if memo:
            out[m]["staged_step_bytes_unnarrowed"] = eng.staged_step_bytes(
                narrow=False)
        leg["state"][0] = eng.sync_cache(leg["state"][0], leg["planner"])
        leg["planner"].close()
        st = leg["state"][0]
        out[m]["fingerprints"] = {"table": _fingerprint(st.table),
                                  "cache": _fingerprint(st.cache)}
    out["alone"]["htod_share"] = (out["off"]["htod_ms_per_step"]
                                  / out["alone"]["step_ms_warm"])
    if memo:
        off, on = legs["off"], legs["on"]
        diff = _differ(off["state"][0], on["state"][0]) + _differ(
            off["losses"], on["losses"]) + _differ(off["losses"],
                                                   alone_losses)
        if diff:
            raise AssertionError(f"scheduled:memo: memo on differs from "
                                 f"memo off in {diff}")
        if not sum(on["hits"]) or sum(on["hits"][:2]):
            raise AssertionError(f"scheduled:memo: hits by epoch "
                                 f"{on['hits']}")
        out["bit_exact"] = True
        out["on_over_off_epoch_s"] = [
            b / a for a, b in zip(off["epoch_s"], on["epoch_s"])]
        del legs["on"], on
        _free()
        # the full wire against the narrowed one, both widened in the
        # captured step: the same stream, losses and state bit for bit
        wire = _memo_leg(cfg, data, False, sched_packed_wire=False)
        for _ in range(SCHED_EPOCHS):
            _memo_epoch(wire)
        while _memo_chunk(wire) is not None:
            pass
        weng = wire["eng"]
        wire["state"][0] = weng.sync_cache(wire["state"][0],
                                           wire["planner"])
        wire["planner"].close()
        rows = {"narrowed": off["row_bytes"], "full": wire["row_bytes"],
                "full_predicted": off["eng"].staged_step_bytes(
                    narrow=False)}
        captures = {"narrowed": off["eng"].graphs.captures,
                    "full": weng.graphs.captures} if weng.graphs else {}
        uncaptured = DEVICE == "cuda" and not (
            captures and all(captures.values()))
        diff = _differ(off["state"][0], wire["state"][0]) + _differ(
            off["losses"], wire["losses"])
        if diff or uncaptured or rows["full"] != rows["full_predicted"] \
                or not rows["narrowed"] < rows["full"]:
            raise AssertionError(f"scheduled:memo: the full wire differs "
                                 f"from the narrowed one in {diff}, "
                                 f"rows {rows}, captures {captures}")
        out["full_wire"] = {"bit_exact": True, "row_bytes": rows,
                            "graph_captures": captures}
        del wire, weng
    del legs
    _free()
    emit(out)
    return out


def phase_scheduled_pinned() -> tuple:
    """The same, tape mode only, with a pinned tier of 4,096 rows over
    frequency-remapped ids. First 8 steps against the same CachedEngine on
    the CPU from a copy of the state (plain versions of every kernel);
    then the timed epochs, K4's add form once and K3 twice per step; then
    one more epoch whose first chunks count the host's waits for the card
    and whose other chunks are profiled (device busy and idle share a
    step); then sync_cache, after which the table's rows [0, 4096) equal
    the hot block. Returns, beside the phase's line, the hot block, 64
    steps' raw uniq (K4's shape on this path) and the ids of 64 batches
    by position (FAE's shape)."""
    cfg, eng, (dense, sparse, labels), probe_s = _sched_setup(PINNED)
    counted = SCHED_EPOCHS * SCHED_ITERS
    total = counted + SCHED_ITERS
    C, W = eng.cache_rows, eng.width
    out = {"phase": "scheduled:pinned", "probe_s": probe_s,
           "pinned_rows": eng.pinned_rows, "U_cap": eng.U_cap,
           "F_cap": eng.F_cap}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        tape_dir = str(Path(tmp) / "tape")
        planner = plan_cache(eng, sparse, tape_dir, epochs=SCHED_EPOCHS + 1)
        tape = {k: np.load(Path(tape_dir) / f"{k}.npy", mmap_mode="r")
                for k in ("fids", "fslots", "pulls", "pfids", "pfslots",
                          "slots", "uniq")}
        want = _expected_launches(tape, counted, pinned=True)
        state = eng.init_cached_state(0)

        # --- 8 steps against the CPU engine, from one state ---
        t0 = time.perf_counter()
        cpu_eng = CachedEngine(cfg, table_rows=FULL_ROWS, device="cpu")
        ref = _tree(lambda t: t.cpu(), state)
        mine = _tree(lambda t: t.clone(), state)
        mine, got = eng.train_epoch_cached(mine, ReplayPlanner(tape_dir),
                                           dense, sparse, labels, steps=8)
        ref, want_l = cpu_eng.train_epoch_cached(
            ref, ReplayPlanner(tape_dir), dense, sparse, labels, steps=8)
        loss_err = float((got["loss"].cpu() - want_l["loss"]).abs().max())
        # rows the 8 steps wrote: cache slots of the batch keys, prefetch
        # inserts and flushes; table rows of the flushes
        sl, uq = np.asarray(tape["slots"][:8]), np.asarray(tape["uniq"][:8])
        ps, pi = np.asarray(tape["pfslots"][:8]), np.asarray(
            tape["pfids"][:8])
        fs, fi = np.asarray(tape["fslots"][:8]), np.asarray(
            tape["fids"][:8])
        slots_w = np.unique(np.concatenate([
            sl[(uq >= 0) & (sl < C)], ps[(pi >= 0) & (ps < C)],
            fs[(fs >= 0) & (fs < C)]]))
        rows_w = np.unique(fi[fi >= 0])
        a = mine.cache[torch.as_tensor(slots_w, device=DEVICE)]
        b = ref.cache[torch.as_tensor(slots_w)].to(DEVICE)
        value_ok = torch.allclose(a[:, :W], b[:, :W], rtol=2 ** -7, atol=0)
        dscale = float(b[:, W:].abs().max())
        delta_err = float((a[:, W:] - b[:, W:]).abs().max())
        hot_ok = torch.allclose(mine.hot_table.float(),
                                ref.hot_table.to(DEVICE).float(), rtol=2 ** -7,
                                atol=0)
        hot_err = float((mine.hot_table.float()
                         - ref.hot_table.to(DEVICE).float()).abs().max())
        written = torch.zeros(C, dtype=torch.bool, device=DEVICE)
        written[torch.as_tensor(slots_w, device=DEVICE)] = True
        same = (mine.cache == ref.cache.to(DEVICE)).all(dim=1)
        untouched_cache = bool(same[~written].all())
        del same, written
        ref_table = ref.table.to(DEVICE)
        trows = torch.as_tensor(rows_w, device=DEVICE, dtype=torch.long)
        table_ok = torch.allclose(mine.table[trows].float(),
                                  ref_table[trows].float(), rtol=2 ** -7,
                                  atol=0)
        same = (mine.table == ref_table).all(dim=1)
        same[trows] = True
        untouched_table = bool(same.all())
        del ref_table, same, trows, a, b
        ok = (loss_err <= 1e-5 and value_ok and hot_ok and table_ok
              and delta_err <= 1e-6 * dscale and untouched_cache
              and untouched_table)
        out["reference"] = {
            "steps": 8, "engine": "CachedEngine(device='cpu')",
            "loss_max_err": loss_err, "value_plane_within_bf16_ulp":
            value_ok, "delta_plane_max_err": delta_err,
            "delta_plane_bound": 1e-6 * dscale, "hot_block_within_bf16_ulp":
            hot_ok, "hot_block_max_err": hot_err,
            "flushed_table_rows": int(rows_w.size),
            "written_cache_rows": int(slots_w.size),
            "untouched_cache_identical": untouched_cache,
            "untouched_table_identical": untouched_table,
            "host_s": time.perf_counter() - t0}
        del ref, mine, cpu_eng
        _free()
        if not ok:
            raise AssertionError(f"the pinned run differs from the CPU "
                                 f"reference: {out['reference']}")

        # --- the timed run ---
        torch.cuda.reset_peak_memory_stats()
        staged = eng.stage_program_chunks(planner, 32,
                                          raw=(dense, sparse, labels))
        holder = [state]
        per_epoch = SCHED_ITERS // 32
        eng.noflush_chunks = eng.nopull_chunks = 0   # the 8 steps' chunk

        def tape_epoch(e):
            outs = []
            for c in range(per_epoch):
                holder[0], stats = eng.train_epoch_staged(
                    holder[0], staged[e * per_epoch + c])
                outs.append(stats)
            return {"loss": torch.cat([o["loss"] for o in outs]),
                    "overflow": torch.cat([o["overflow"] for o in outs])}

        for k in KERNELS.values():
            k.launches = 0
        times, last = _epochs_timed(tape_epoch, SCHED_EPOCHS)
        launches = _check_launches("the pinned scheduled path", want)
        warm = times[2:] if eng.nopull_chunks else times[1:]

        def run_chunk(i):
            holder[0], _ = eng.train_epoch_staged(
                holder[0], staged[SCHED_EPOCHS * per_epoch + i])

        n_wait = max(1, per_epoch // 4)
        waits, sites = _count_host_waits(
            lambda: [run_chunk(c) for c in range(n_wait)])
        profile = _profile_chunks(lambda i: run_chunk(n_wait + i),
                                  per_epoch - n_wait, 32)
        profile["host_waits_per_step"] = waits / (32 * n_wait)
        profile["host_wait_sites"] = sites
        _no_waits("scheduled:pinned", waits, sites)
        profile["busy_gate"] = _busy_gate("scheduled:pinned",
                                          profile["device_busy_ms"])
        state = eng.sync_cache(holder[0], planner)
        del holder, staged
        if not torch.equal(state.table[:PINNED], state.hot_table):
            raise AssertionError("after sync_cache the table's rows "
                                 "[0, 4096) differ from the hot block")
        # K4's shape on this path: the hot block and 64 steps' raw uniq
        uniqs = [torch.as_tensor(np.array(tape["uniq"][i]), device=DEVICE)
                 for i in range(64)]
        out.update({
            "pinned_examples_per_s": BATCH * SCHED_ITERS / min(warm),
            "epoch_examples_per_s": [BATCH * SCHED_ITERS / t
                                     for t in times],
            "step_ms": min(warm) / SCHED_ITERS * 1e3,
            "launches": launches, "expected": want,
            "chunks": {"full": (SCHED_EPOCHS + 1) * per_epoch
                       - eng.noflush_chunks,
                       "flush_free": eng.noflush_chunks - eng.nopull_chunks,
                       "pull_free": eng.nopull_chunks},
            "loss_last": last[-1], "hot_block_equals_table_rows": True,
            "step_profile": profile,
            "cache": cache_report(planner, total, eng.ids_per_worker),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "evaluate": _eval_after_sync(eng, state)})
        planner.close()
        hot = state.hot_table.clone()
        del state
        _free()
    if GRAPHS:
        out["captured_vs_uncaptured"] = _pinned_twin()
        _free()
    emit(out)
    positions = [torch.as_tensor(sparse[i * BATCH:(i + 1) * BATCH]
                                 .reshape(-1), device=DEVICE)
                 for i in range(64)]
    return out, hot, uniqs, positions


def _pinned_twin() -> dict:
    """Captured against uncaptured CachedEngine at full width on a stream
    that flushes: a 4,096-row pinned tier over frequency-remapped ids and
    a cache of twice one step's ids (13,312 slots), so rows are evicted
    and flushed on most steps. From one state, TWIN_STEPS steps in chunks
    of 16 through train_epoch_cached on each engine, both replaying one
    plan tape; every leaf of the two states (table, cache, hot block,
    dense) and every loss must be equal bit for bit."""
    cfg = HeraldConfig(model="wdl_criteo", batch_size=BATCH,
                       embedding_dim=EMB, learning_rate=0.01,
                       table_dtype=torch.bfloat16, use_cache=True,
                       use_scheduler=True, cache_limit=2 * BATCH * 26,
                       pinned_rows=PINNED)
    dense, sparse, labels = synthetic_ctr_data(
        DATASETS["criteo"], BATCH * TWIN_STEPS, seed=2, num_rows=FULL_ROWS)
    sparse, _ = frequency_remap(sparse, FULL_ROWS)
    data = (dense.astype(np.float32), sparse.astype(np.int32),
            labels.astype(np.float32))
    eng = CachedEngine(cfg, table_rows=FULL_ROWS, device=DEVICE)
    eager = CachedEngine(HeraldConfig(**cfg.__dict__), table_rows=FULL_ROWS,
                         device=DEVICE, cuda_graphs=False)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        tape = Path(tmp) / "tape"
        plan_cache(eng, data[1], str(tape), epochs=1).close()
        fids = np.load(tape / "fids.npy")
        state = eng.init_cached_state(0)
        twin = _tree(lambda t: t.clone(), state)
        mine, theirs = ReplayPlanner(str(tape)), ReplayPlanner(str(tape))
        got, want, tally, tally_e = [], [], {}, {}
        for _ in range(TWIN_STEPS // 16):
            state, a = _tallied(tally, lambda: eng.train_epoch_cached(
                state, mine, *data, steps=16))
            twin, b = _tallied(tally_e, lambda: eager.train_epoch_cached(
                twin, theirs, *data, steps=16))
            got.append(a["loss"])
            want.append(b["loss"])
        mine.close()
        theirs.close()
    out = {"steps": TWIN_STEPS, "cache_rows": eng.cache_rows,
           "steps_with_flush": int((fids[:TWIN_STEPS] >= 0).any(axis=1)
                                   .sum()),
           "losses_differ": _differ(got, want),
           "state_differ": _differ(state, twin),
           "launches": tally, "uncaptured_launches": tally_e,
           "graphs": eng.graphs.captures}
    del state, twin
    _same_launches(out)
    if out["losses_differ"] or out["state_differ"] \
            or not out["steps_with_flush"]:
        raise AssertionError(f"captured pinned steps differ from "
                             f"uncaptured, or none flushed: {out}")
    return out


TWIN_STEPS = 64


def _hot_gather_cases(hot, uniqs):
    """(label, hot table, ids) cases on the card: the shape of
    tests/test_pallas_kernels.py:49-59, negative ids, N = 0, D = 13 (no
    16-byte vectors), D = 513 (odd bf16 rows), f32 and bf16, int32 and
    int64 ids, and the pinned path's own shape and raw uniq."""
    rng = np.random.default_rng(4)
    g = torch.Generator(device=DEVICE).manual_seed(4)
    for dt in (torch.float32, torch.bfloat16):
        for H, D, N in ((256, 128, 96), (300, 13, 500), (64, 128, 0),
                        (1000, 513, 700), (4096, 128, 6656)):
            table = torch.randn((H, D), generator=g, device=DEVICE).to(dt)
            ids = np.where(rng.random(N) < 0.7, rng.integers(0, H, N),
                           1_000_000)
            neg = rng.random(N) < 0.1
            ids[neg] = -rng.integers(1, 2 * H, int(neg.sum()))
            for idt in (torch.int32, torch.int64):
                yield (f"{str(dt)[6:]} H={H} D={D} N={N} {str(idt)[6:]}",
                       table, torch.as_tensor(ids, dtype=idt,
                                              device=DEVICE))
    for i in (0, 63):
        yield (f"pinned path bf16 [4096, 128], step {i} raw uniq "
               f"(U_cap {uniqs[i].numel()})", hot, uniqs[i])


def _hot_add_check(label, tab, ids, strided: bool) -> None:
    """The add form into an f32 acc holding -0.0 in every third row (cold
    rows among them), contiguous or the value half of an [N, 2D] read,
    against its plain version bit for bit over the whole buffer: the
    rows of cold ids and the other half keep their bits."""
    N, D = ids.numel(), tab.shape[1]
    g = torch.Generator(device=DEVICE).manual_seed(N + D)
    buf = torch.randn((N, 2 * D if strided else D), generator=g,
                      device=DEVICE)
    buf[::3] = -0.0
    want = buf.clone()
    k4_ops.hot_onehot_gather_add_ref(want[:, :D], tab, ids)
    got = k4_ops.hot_onehot_gather_add_(buf[:, :D], tab, ids)
    torch.cuda.synchronize()
    if got.data_ptr() != buf.data_ptr() or not torch.equal(
            buf.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"hot_onehot_gather_add_ differs from its "
                             f"plain version ({label}, "
                             f"{'strided' if strided else 'contiguous'} acc)")


def _add_entry(acc, hot, ids):
    """The add form's C entry point on prepared arguments: the part of a
    wrapper call that is the ctypes call and the launch."""
    fn = k4_ops._add_launcher()
    args = (hot.data_ptr(), ids.data_ptr(), acc.data_ptr(), hot.shape[0],
            hot.shape[1], ids.numel(), acc.stride(0), 1, 0)
    return lambda: fn(*args, torch._C._cuda_getCurrentRawStream(0))


def _k4_timing(hot, ids, acc) -> dict:
    """K4's two forms on one shape, each launch on the ids of another step
    or batch: the add form into `acc` (in place, one buffer, as the step
    adds into its own rows) beside its plain version and the route it
    replaced (K4's gather, `.to(float32)`, an out-of-place add: device ms
    summed over its launches); the gather beside its plain version and
    `index_select` + `masked_fill_`. Events ms and torch.profiler's device
    ms; bounds by bytes from this run's hot ids."""
    k, n = len(ids), ids[0].numel()
    H, D = hot.shape
    row, idb = D * hot.element_size(), ids[0].element_size()
    hot_ids = [u[(u >= 0) & (u < H)] for u in ids]
    hits = sum(h.numel() for h in hot_ids) / k
    # the hot rows a launch must read: its distinct in-range ids (at the
    # pinned shape each id is there once; at FAE's, hot ids repeat)
    distinct = sum(torch.unique(h).numel() for h in hot_ids) / k
    clamped = [u.clamp(0, H - 1) for u in ids]
    cold = [((u < 0) | (u >= H)).unsqueeze(1) for u in ids]
    fns = {
        "add": lambda i: k4_ops.hot_onehot_gather_add_(acc, hot,
                                                       ids[i % k]),
        "add_plain": lambda i: k4_ops.hot_onehot_gather_add_ref(
            acc, hot, ids[i % k]),
        "replaced": lambda i: acc + hot_onehot_gather(
            hot, ids[i % k]).to(torch.float32),
        "gather": lambda i: hot_onehot_gather(hot, ids[i % k]),
        "gather_plain": lambda i: hot_onehot_gather_ref(hot, ids[i % k]),
        "gather_library": lambda i: torch.index_select(
            hot, 0, clamped[i % k]).masked_fill_(cold[i % k], 0)}
    marker = {"add": HOT_ADD, "gather": HOT_GATHER, "replaced": HOT_GATHER}
    ev = {what: cuda_ms(f, k) for what, f in fns.items()}
    prof = {what: device_profile(f, k, marker=marker.get(what))
            for what, f in fns.items()}
    # ids read once, each distinct hot row read once; add: the acc row of
    # each hot position read and written once; gather: every out row
    # written once
    add_bytes = n * idb + distinct * row + hits * 2 * D * 4
    gather_bytes = n * idb + distinct * row + n * row
    base = {"steps": k, "n": n, "hot_rows": H, "width": D,
            "mean_hot_ids": hits, "mean_distinct_hot_ids": distinct,
            "hot_share": hits / n}
    add = {**base, "kernel_ms": ev["add"], "plain_ms": ev["add_plain"],
           "library_ms": None, "library_device_ms": None,
           "replaced_ms": ev["replaced"],
           "kernel_device_ms": _own_ms(prof["add"][1], HOT_ADD),
           "plain_device_ms": prof["add_plain"][0],
           "replaced_device_ms": prof["replaced"][0],
           "replaced_top_device_ms": prof["replaced"][1],
           "profiler_sessions": {what: p[3] for what, p in prof.items()},
           "bound_ms": add_bytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "bytes_per_launch": add_bytes,
           "bound_note": "ids read once, distinct hot rows read once, the "
                         "acc rows of hot positions read and written once",
           "library_note": "none: no single PyTorch call adds rows read "
                           "by id into place",
           "replaced_note": "K4's gather + .to(float32) + add, the "
                            "pinned read before the add form"}
    gather = {**base, "kernel_ms": ev["gather"],
              "plain_ms": ev["gather_plain"],
              "library_ms": ev["gather_library"],
              "kernel_device_ms": _own_ms(prof["gather"][1], HOT_GATHER),
              "plain_device_ms": prof["gather_plain"][0],
              "library_device_ms": prof["gather_library"][0],
              "bound_ms": gather_bytes / HBM_BYTES_PER_S * 1e3,
              "bound_by": "bytes", "bytes_per_launch": gather_bytes,
              "bound_note": "ids read once, distinct hot rows read once, "
                            "every out row written once",
              "library_note": "index_select on clamped ids + masked_fill_ "
                              "(clamp and mask made outside the timing)"}
    return {"add": add, "gather": gather}


def phase_kernel_hot_gather(hot, uniqs, positions) -> tuple:
    """K4's gather and add forms against their plain versions, bit for
    bit (the add form contiguous and strided, -0.0 in cold rows), then
    timed at the pinned path's shape (the [4096, 128] bf16 hot block at
    each of 64 steps' raw uniq: U_cap wide, -1 padding, ids >= 4096) and
    at FAE's: a bf16 hot block of 1% of the Criteo rows ([337,625, 128],
    86 MB, more than L2 holds) read at the 6,656 positions of each of 64
    batches, hot where the frequency-remapped id falls in it (the data's
    own share), and again with half of those positions made cold."""
    cases = 0
    for label, tab, ids in _hot_gather_cases(hot, uniqs):
        got = hot_onehot_gather(tab, ids)
        want = hot_onehot_gather_ref(tab, ids)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"hot_onehot_gather differs from its plain "
                                 f"version ({label})")
        for strided in (False, True):
            _hot_add_check(label, tab, ids, strided)
        cases += 1
    refused = _refusals(
        lambda: k4_ops.hot_onehot_gather_add_(
            torch.zeros((uniqs[0].numel(), EMB), dtype=torch.float64,
                        device=DEVICE), hot, uniqs[0]),
        lambda: k4_ops.hot_onehot_gather_add_(
            torch.zeros((EMB, uniqs[0].numel()), device=DEVICE).t(), hot,
            uniqs[0]))
    D = hot.shape[1]
    acc = torch.randn((uniqs[0].numel(), 2 * D), device=DEVICE)[:, :D]
    pinned = _k4_timing(hot, uniqs, acc)
    pinned["add"]["wrapper_host_us"] = _wrapper_host_us(
        lambda: k4_ops.hot_onehot_gather_add_(acc, hot, uniqs[0]),
        _add_entry(acc, hot, uniqs[0]), None,
        lambda: k4_ops.check_add_args(acc, hot, uniqs[0]),
        route=lambda: acc + hot_onehot_gather(hot, uniqs[0]).to(
            torch.float32))
    # a control for the profiler's pad: the add form's session once
    # without it
    pinned["add"]["profiler_no_pad"] = device_profile(
        lambda i: k4_ops.hot_onehot_gather_add_(acc, hot,
                                                uniqs[i % len(uniqs)]),
        len(uniqs), HOT_ADD, pad=0, tries=1)[3]
    del acc
    H_fae = FULL_ROWS // 100
    g = torch.Generator(device=DEVICE).manual_seed(7)
    hot_fae = torch.randn((H_fae, D), generator=g, device=DEVICE).to(
        torch.bfloat16)
    acc = torch.zeros((positions[0].numel(), D), device=DEVICE)
    rng = np.random.default_rng(7)
    fae = []
    for half in (False, True):
        ids = []
        for p in positions:
            hot_idx = torch.where(p < H_fae, p, -1)
            if half:
                drop = torch.as_tensor(rng.random(p.numel()) < 0.5,
                                       device=DEVICE)
                hot_idx = torch.where(drop, -1, hot_idx)
            ids.append(hot_idx)
        fae.append(_k4_timing(hot_fae, ids, acc))
        fae[-1]["add"]["hot_share_note"] = fae[-1]["gather"][
            "hot_share_note"] = (
            "the data's own: positions whose frequency-remapped id "
            "(bench_scheduled's 65,536 samples) is among the 1% hottest"
            + (", then half of them made cold at random" if half else ""))
    del hot_fae, acc
    out = {"cases": cases, "max_abs_err": 0.0,
           "refused_wrong_acc": refused}
    gather = {"name": "hot_onehot_gather", **out, **pinned["gather"],
              "fae": [f["gather"] for f in fae]}
    add = {"name": "hot_onehot_gather_add_", **out, **pinned["add"],
           "fae": [f["add"] for f in fae]}
    emit({"phase": "kernel:hot_onehot_gather", "gather": gather,
          "add": add})
    return gather, add


class _MirrorDump:
    """The dirty (id, slot) pairs of a mid-stream cached state, from the
    residency mirror its checkpoint's serve overlay carries: the slots
    whose delta plane is not zero. Stands in for a drained planner's
    `dirty_rows` so that `sync_cache` gives the synced state at that
    step."""

    def __init__(self, mirror, cache, width):
        dirty = (cache[:, width:] != 0).any(dim=1).cpu().numpy()
        slots = np.flatnonzero((mirror[0] >= 0) & dirty)
        self.rows = (mirror[0][slots], slots.astype(np.int32))

    def dirty_rows(self, worker):
        return self.rows


def phase_launch_scheduled() -> dict:
    """The scheduled launcher, in subprocesses: a full-width run with a
    plan tape, device data and a pinned tier; at 4,096 rows a run stopped
    mid-stream with serve-view checkpoints, then resumed, whose final
    table must equal the uninterrupted run's bit for bit; the mid-stream
    checkpoint served by `python -m herald_tpu_torch.serve` against
    Engine.predict on that state after sync_cache."""
    launch = ["herald_tpu_torch.launch", "--scheduled", "--model",
              "wdl_criteo", "--bf16-table"]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        full = _report(_run(launch + [
            "--batch-size", str(BATCH), "--embedding-size", str(EMB),
            "--rows", str(FULL_ROWS), "--samples", "65536", "--scan-steps",
            "32", "--nepoch", "2", "--plan-cache", str(tmp / "tape"),
            "--device-data", "--pinned-rows", str(PINNED)], timeout=900))
        full_s = time.perf_counter() - t0
        spe = (65536 - int(65536 * 0.1)) // BATCH   # --val-ratio 0.1
        if full["steps"] != 2 * spe or full["overflow_rows"] \
                or not np.isfinite(full["train_loss_last"]) \
                or full["val_auc"] is None \
                or not full["examples_per_sec_steady"]:
            raise AssertionError(f"full-width scheduled launch: {full}")
        rows = 4096
        small = launch + ["--rows", str(rows), "--samples", "8192",
                          "--batch-size", "64", "--cache-limit-ratio", "0.5",
                          "--scan-steps", "8", "--nepoch", "2", "--lr", "0.5",
                          "--ckpt-serve-view"]
        whole = _report(_run(small + ["--ckpt", str(tmp / "whole"),
                                      "--save-config",
                                      str(tmp / "cfg.json")]))
        part = _report(_run(small + ["--ckpt", str(tmp / "part"),
                                     "--ckpt-every", "16", "--max-steps",
                                     "48"]))
        rest = _report(_run(small + ["--resume", str(tmp / "part"),
                                     "--ckpt", str(tmp / "rest")]))
        if not part["stopped_early"] or part["steps"] != 48 \
                or part["steps"] + rest["steps"] != whole["steps"]:
            raise AssertionError(f"steps {part['steps']} + {rest['steps']} "
                                 f"!= {whole['steps']}")
        a = load_cached_checkpoint(str(tmp / "whole"), DEVICE)
        b = load_cached_checkpoint(str(tmp / "rest"), DEVICE)
        if int(a.step) != whole["steps"] or not all(
                torch.equal(x, y) for x, y in
                ((a.table, b.table), (a.cache, b.cache),
                 (a.hot_table, b.hot_table))) or not all(
                torch.equal(a.dense[k], b.dense[k]) for k in a.dense):
            raise AssertionError("the resumed scheduled run's final state "
                                 "differs from the uninterrupted run's")
        del a, b
        # the mid-stream checkpoint (step 48): served with its overlay,
        # against predict on the same state after sync_cache
        cfg = HeraldConfig.from_json((tmp / "cfg.json").read_text())
        eng = CachedEngine(cfg, table_rows=rows, device=DEVICE)
        mid = load_cached_checkpoint(str(tmp / "part"), DEVICE)
        overlay = load_extra(str(tmp / "part"), "serve_overlay")
        synced = eng.sync_cache(mid, _MirrorDump(overlay["mirror"],
                                                 mid.cache, eng.width))
        dense, sparse, _ = synthetic_ctr_data(eng.model.spec, BATCH, seed=3,
                                              num_rows=rows)
        want = eng.predict(synced, dense, sparse).cpu().numpy()
        served = _served_by_entry_point(tmp / "part", tmp / "cfg.json",
                                        rows, dense, sparse)
        serve_err = float(np.abs(served - want).max())
        # the overlay widens rows and deltas to f32 before the update;
        # the flush rounds the delta to bf16 first: a row can land one
        # bf16 ulp apart, a score by ~1e-4
        if serve_err > 1e-3:
            raise AssertionError(f"served mid-stream scores differ from "
                                 f"predict after sync_cache by {serve_err}")
    out = {"phase": "launch:scheduled", "full_width": {
        k: full[k] for k in ("steps", "train_loss_last", "val_auc",
                             "val_acc", "examples_per_sec",
                             "examples_per_sec_steady",
                             "examples_per_sec_steady_segments",
                             "noflush_chunks", "nopull_chunks", "device")},
        "full_width_cache_miss_rate": full["cache"]["miss_rate"],
        "full_width_command_s": full_s, "rows_small": rows,
        "small_steps": whole["steps"], "resumed_at": part["steps"],
        "resume_bit_exact": True, "served_midstream_max_err": serve_err,
        "overlay_rows": int(len(overlay["rows"]))}
    emit(out)
    return out



# ----------------------------------------------------------------------
# the launcher's input feed (the prefetcher, the prestager, the raw-data
# preprocessor)
# ----------------------------------------------------------------------

# the tree whose package this script imported (--root), whose launcher
# the feed phase runs
PKG_ROOT = Path(herald_tpu_torch.__file__).resolve().parents[1]
FEED_LINES, FEED_K, FEED_SAMPLES = 400_000, 32, 400_000
# the size from which the preprocessor takes its native parser
FEED_MIN_MB = 64 * 1024 * 1024 / 1e6
# written before the first chip run of the feed phase (NVIDIA H100 80GB
# HBM3, 700.00 W in every earlier run): [low, high]
FEED_PREDICTED = {
    "preprocess_mb_per_s": [60, 150],
    "plain_examples_per_sec": {"prefetch": [750e3, 1.0e6],
                               "no_prefetch": [600e3, 850e3]},
    "scheduled_examples_per_sec_steady": {"0": [280e3, 400e3],
                                          "3": [450e3, 650e3],
                                          "all": [750e3, 950e3]},
    # written before the re-measure of every launch in this process
    "scheduled_examples_per_sec": {"0": [150e3, 250e3],
                                   "3": [250e3, 400e3],
                                   "all": [180e3, 300e3]},
    "idle_share_profiled_all": [0.15, 0.35],
    "pinned_pool_peak_mb_all": [32, 64]}
FEED_CLOCKS = ("examples_per_sec", "examples_per_sec_steady",
               "examples_per_sec_steady_segments", "timing")


def _write_raw_criteo(path: Path, lines: int, seed: int = 0) -> None:
    """A raw Criteo-layout TSV (Kaggle train.txt) from `seed`: the label,
    13 integer columns and 26 hex categorical columns, a tenth of the
    cells blank, each categorical column a Zipf law (a = 1.2) over a
    vocabulary of its own (4 to 2,000,000 values)."""
    rng = np.random.default_rng(seed)
    vocab = np.geomspace(4, 2_000_000, 26).astype(np.int64)
    hex2 = np.frombuffer(b"".join(b"%02x" % i for i in range(256)),
                         np.uint8).reshape(256, 2)
    with open(path, "wb") as f:
        for lo in range(0, lines, 50_000):
            n = min(50_000, lines - lo)
            label = rng.integers(0, 2, n).astype("S1")
            ints = rng.integers(0, 1000, (n, 13)).astype("S3")
            ints[rng.random((n, 13)) < 0.1] = b""
            ids = ((rng.zipf(1.2, (n, 26)) - 1) % vocab * 2654435761
                   + np.arange(26) * 7919) % (1 << 32)
            cats = np.ascontiguousarray(hex2[ids.astype(">u4").view(
                np.uint8).reshape(n, 26, 4)].reshape(n, 26, 8)).view(
                "S8").reshape(n, 26)
            cats[rng.random((n, 26)) < 0.1] = b""
            f.write(b"\n".join(
                a + b"\t" + b"\t".join(i) + b"\t" + b"\t".join(c)
                for a, i, c in zip(label.tolist(), ints.tolist(),
                                   cats.tolist())) + b"\n")


def _feed_run(argv, timeout=900):
    """(report, command s) of a launch from the imported tree, a process
    of its own."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *argv], cwd=PKG_ROOT,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(argv[:8])} exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    return _report(proc.stdout), time.perf_counter() - t0


HOST_KEYS = ("allocated_bytes.current", "allocated_bytes.peak",
             "active_bytes.current", "num_host_alloc")


def _host_stats() -> dict:
    """The caching host allocator's pinned bytes: `allocated_bytes`, what
    it holds from cudaHostAlloc (blocks in use and cached free ones), and
    `active_bytes`, which `_active_bytes_probe` reads."""
    stats = torch.cuda.host_memory_stats()
    return {k: stats.get(k) for k in HOST_KEYS}


def _feed_here(argv, env=None):
    """(report, seconds, the state handed to its last save, the pinned
    host memory of the run) of `python -m herald_tpu_torch.launch ARGV`
    run in this process through `cli.run_training`, its output kept out
    of this script's, with `train/checkpoint.py`'s `save_checkpoint`
    replaced by a recorder: the full-width states (8.6-12.1 GB) are
    compared in device memory (written to disk, five of them took 320 s
    to write back on the H100 machine, about 150-200 MB/s). The pinned
    memory: the host allocator's peak over the run, its peak reset
    first."""
    from herald_tpu_torch.launch import cli
    from herald_tpu_torch.train import checkpoint
    saved = []
    real, env = checkpoint.save_checkpoint, env or {}
    before = {k: os.environ.get(k) for k in env}
    checkpoint.save_checkpoint = lambda state, path, **kw: saved.append(
        state)
    os.environ.update(env)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_host_memory_stats()
    host0 = _host_stats()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rep = cli.run_training(cli.build_parser().parse_args(argv[1:]))
    finally:
        checkpoint.save_checkpoint = real
        for k, v in before.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    host1 = _host_stats()
    pinned = {"pool_peak_bytes": host1["allocated_bytes.peak"],
              "pool_bytes_at_start": host0["allocated_bytes.current"],
              "host_allocs": host1["num_host_alloc"]
              - host0["num_host_alloc"],
              "active_bytes_added": host1["active_bytes.current"]
              - host0["active_bytes.current"]}
    return rep, secs, saved[-1] if saved else None, pinned


def _active_bytes_probe(blocks: int = 28, nbytes: int = 12_800_000
                        ) -> dict:
    """What the host allocator's `active_bytes` counts: `blocks` pinned
    buffers of `nbytes` (a staged chunk's size) allocated one after the
    other, each copied to the card on a side stream and freed once the
    copy has landed, so that one cached block serves them all. The
    allocator's bytes from cudaHostAlloc do not grow. In torch 2.11
    `active_bytes` gains a block at each reuse and never loses it: a
    block released through its copy's event is taken back as `size`, the
    argument of `process_events_for_specific_size`, which is -1 there
    (`ATen/core/CachingHostAllocator.h`), so it counts reuses, not memory
    held."""
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    h0 = _host_stats()
    for _ in range(blocks):
        with torch.cuda.stream(side):
            host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            dev = host.to(DEVICE, non_blocking=True)
        del host, dev
        torch.cuda.synchronize()
    h1 = _host_stats()
    return {"blocks": blocks, "nbytes": nbytes,
            "host_allocs": h1["num_host_alloc"] - h0["num_host_alloc"],
            "allocated_bytes_added": h1["allocated_bytes.current"]
            - h0["allocated_bytes.current"],
            "active_bytes_added": h1["active_bytes.current"]
            - h0["active_bytes.current"]}


def _feed_untimed(rep: dict) -> dict:
    out = {k: v for k, v in rep.items() if k not in FEED_CLOCKS}
    if "cache" in out:
        out["cache"] = {k: v for k, v in out["cache"].items()
                        if k != "plan_time_us"}
    return out


def _same_ckpt(a: Path, b: Path) -> dict:
    """Two checkpoint directories hold the same files: every .npz member's
    dtype and bytes, every other file byte for byte."""
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    if fa != fb or not fa:
        raise AssertionError(f"checkpoint files differ: {fa} / {fb}")
    n_bytes = 0
    for rel in fa:
        if rel.suffix != ".npz":
            if (a / rel).read_bytes() != (b / rel).read_bytes():
                raise AssertionError(f"{rel} differs")
            continue
        with np.load(a / rel) as x, np.load(b / rel) as y:
            if sorted(x.files) != sorted(y.files) or any(
                    x[k].dtype != y[k].dtype
                    or x[k].tobytes() != y[k].tobytes() for k in x.files):
                raise AssertionError(f"{rel} differs")
            n_bytes += sum(x[k].nbytes for k in x.files)
    return {"files": len(fa), "npz_bytes": n_bytes}


def _trace_window(path: Path) -> dict:
    """From a launcher's torch.profiler trace (`--log-dir`): the device's
    idle share over the steps (from the first graph replay past the first
    tenth to the end of the last device event: training and eval steps,
    each a batch), device busy a replay, replays a second, and the streams
    of the host-to-device copies beside the streams of the kernels."""
    mb = path.stat().st_size / 1e6
    trace = json.loads(path.read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    dev = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                 and e.get("ph") == "X")
    replays = sorted(e["ts"] for e in events
                     if e.get("name") in ("cudaGraphLaunch", "cuGraphLaunch")
                     and e.get("ph") == "X")
    if not dev or not replays:
        return {"idle_share": None, "replays": len(replays)}
    first = len(replays) // 10
    lo, hi = replays[first], dev[-1][1]
    busy, end = 0.0, lo
    for s, e in dev:
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    kernels, copies = {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        stream = e.get("args", {}).get("stream")
        if e.get("cat") == "kernel":
            kernels[stream] = kernels.get(stream, 0) + 1
        elif e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""):
            c = copies.setdefault(str(stream), {"copies": 0, "bytes": 0})
            c["copies"] += 1
            c["bytes"] += int(e.get("args", {}).get("bytes", 0))
    compute = max(kernels, key=kernels.get)
    n = len(replays) - first
    return {"trace_mb": mb, "idle_share": 1.0 - busy / max(hi - lo, 1e-9),
            "window_ms": (hi - lo) / 1e3, "busy_ms": busy / 1e3,
            "replays": len(replays), "replays_in_window": n,
            "busy_ms_per_replay": busy / 1e3 / n,
            "batches_per_s": n / max(hi - lo, 1e-9) * 1e6,
            "compute_stream": compute,
            "htod_by_stream": copies,
            "htod_off_compute_stream": sum(
                c["copies"] for s, c in copies.items() if s != str(compute))}


def _feed_group(name: str, tmp: Path, variants: dict) -> dict:
    """Launch each variant {label: (argv, env)} in this process with
    --ckpt, then again with --log-dir: every report equal to the first's
    but for its clocks, every final state equal to the first's in device
    memory. {label: {report, seconds, pinned, and the profiled run's
    seconds, steady rate and trace}}."""
    first, out = None, {}
    for label, (argv, env) in variants.items():
        for prof in (False, True):
            tag = f"{name}-{label}-{'prof' if prof else 'run'}"
            extra = ["--ckpt", str(tmp / f"ck-{tag}")]
            if prof:
                extra += ["--log-dir", str(tmp / f"log-{tag}")]
            rep, secs, state, pinned = _feed_here(argv + extra, env)
            if first is None:
                first = (label, rep, state)
            else:
                diff = _differ(first[2], state)
                if diff or _feed_untimed(rep) != _feed_untimed(first[1]):
                    raise AssertionError(
                        f"{name} {label}{' profiled' if prof else ''}: "
                        f"{rep} against {first[0]}: {first[1]}; the saved "
                        f"states differ in {diff}")
            del state
            _free()
            if prof:
                trace = tmp / f"log-{tag}" / "trace.json"
                out[label].update(
                    profiled_s=secs, profiled_examples_per_sec_steady=rep.get(
                        "examples_per_sec_steady"),
                    profile=_trace_window(trace))
                trace.unlink()
            else:
                out[label] = {"report": rep, "seconds": secs,
                              "pinned": pinned}
    del first
    _free()
    return out


def phase_launch_feed(raw: bool) -> dict:
    """launch:feed, the imported tree's launcher:
    - with `raw`, a raw Criteo TSV of FEED_LINES lines from seed 0 (>= 64
      MB, so that the native parser runs), preprocessed in this process
      (MB/s) and by `--preprocess-raw` in the plain prefetched launch
      (the same six files, byte for byte), and every full-width launch
      trains on the processed files; without, on --samples FEED_SAMPLES
      (`--phase feed`: the same data for a parent tree under --root);
    - the plain launcher at full width, 2 epochs in chunks of FEED_K
      (which do not divide an epoch's steps), with the prefetcher and
      with --no-prefetch;
    - the scheduled launcher at full width (--pinned-rows 4096
      --plan-cache --device-data, 2 epochs) at --prestage 0, at
      --prestage 3 --prestage-threads 2 (HERALD_PRESTAGE_BUDGET=0, so
      that the whole stream is not staged first) and at --prestage all;
    - after one short untimed launch, every full-width launch twice in
      this process (`_feed_group`), the second time profiled: equal
      reports (steps, losses, evals, cache counters, overflow 0) and
      final states (table, tower; cache and hot block), the idle share
      and the copies' streams of each mode, the pinned host memory of
      each run, and what `active_bytes` counts (`_active_bytes_probe`);
    - 2 gloo ranks on card 0 at 65,536 rows, batch 256 a rank: --scheduled
      --prestage 3 against --prestage 0 and the prefetched plain run
      against --no-prefetch, 2 epochs of 28 global steps in chunks of 8,
      every launch at once, reports and checkpoints exact."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    full = ["herald_tpu_torch.launch", "--model", "wdl_criteo",
            "--bf16-table", "--rows", str(FULL_ROWS), "--batch-size",
            str(BATCH), "--embedding-size", str(EMB), "--scan-steps",
            str(FEED_K), "--nepoch", "2"]
    out = {"phase": "launch:feed", "nvidia_smi": smi, "raw": raw,
           "predicted": FEED_PREDICTED, "marks_s": {}}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t_phase = time.perf_counter()

    def mark(name):     # seconds since the phase started, by step
        out["marks_s"][name] = time.perf_counter() - t_phase

    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        data = pf_data = ["--samples", str(FEED_SAMPLES)]
        if raw:
            from herald_tpu_torch.data import preprocess_criteo
            src = tmp / "train.txt"
            t0 = time.perf_counter()
            _write_raw_criteo(src, FEED_LINES)
            write_s = time.perf_counter() - t0
            mb = src.stat().st_size / 1e6
            if mb < FEED_MIN_MB:
                raise AssertionError(f"the raw file holds {mb} MB")
            t0 = time.perf_counter()
            host_build.preproc_lib_path()       # built outside the clock
            build_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            preprocess_criteo(str(src), str(tmp / "ref"), seed=0)
            pp_s = time.perf_counter() - t0
            out["preprocess"] = {"raw_mb": mb, "lines": FEED_LINES,
                                 "write_s": write_s, "build_s": build_s,
                                 "seconds": pp_s, "mb_per_s": mb / pp_s}
            data = ["--data-path", str(tmp / "ref")]
            # the prefetched plain run preprocesses the raw file itself
            pf_data = ["--preprocess-raw", str(src), "--data-path",
                       str(tmp / "pp")]
            mark("preprocess")
        # the first full-width launch of a process pays one-time costs
        # that later ones do not (two identical launches of one tree, the
        # first the slower): a short one runs first, untimed
        _feed_here(full + data + ["--no-prefetch", "--max-steps",
                                  str(FEED_K)])
        _free()
        mark("warm-up")
        plain = _feed_group("plain", tmp, {
            "prefetch": (full + pf_data, None),
            "no_prefetch": (full + data + ["--no-prefetch"], None)})
        mark("plain")
        rep = plain["prefetch"]["report"]
        if rep["steps"] // 2 % FEED_K == 0 or not 0.0 <= rep["val_auc"] <= 1:
            raise AssertionError(f"plain feed: {rep}")
        if raw:
            names = sorted(p.name for p in (tmp / "ref").glob("*.npy"))
            if len(names) != 6 or any(
                    (tmp / "ref" / n).read_bytes()
                    != (tmp / "pp" / n).read_bytes() for n in names):
                raise AssertionError("--preprocess-raw wrote other files "
                                     "than preprocess_criteo")
            out["preprocess"]["launcher_files_equal"] = True
        sched = full + data + ["--scheduled", "--pinned-rows", str(PINNED),
                               "--device-data", "--prestage-threads", "2"]
        runs = _feed_group("scheduled", tmp, {
            p: (sched + ["--prestage", p, "--plan-cache",
                         str(tmp / f"tape-{p}")],
                {"HERALD_PRESTAGE_BUDGET": "0"} if p == "3" else None)
            for p in ("0", "3", "all")})
        mark("scheduled")
        rep = runs["0"]["report"]
        if rep["overflow_rows"] or rep["val_auc"] is None:
            raise AssertionError(f"scheduled feed: {rep}")
        for name, group in (("plain", plain), ("scheduled", runs)):
            out[name] = {
                "steps": group[next(iter(group))]["report"]["steps"],
                "val_auc": group[next(iter(group))]["report"]["val_auc"],
                "states_equal": True,
                **{k: {m: r["report"].get(k) for m, r in group.items()}
                   for k in ("examples_per_sec", "examples_per_sec_steady",
                             "examples_per_sec_steady_segments")},
                **{k: {m: r[k] for m, r in group.items()}
                   for k in ("seconds", "profiled_s",
                             "profiled_examples_per_sec_steady", "profile",
                             "pinned")}}
        out["scheduled"].update(
            cache=rep["cache"], noflush_chunks=rep["noflush_chunks"],
            # 2 epochs: the memo's hits start at the third
            **{k: {m: r["report"].get(k) for m, r in runs.items()}
               for k in ("chunk_memo_hits", "chunk_memo_active")})
        out["active_bytes_probe"] = _active_bytes_probe()
        out["two_ranks"] = _feed_two_ranks(tmp)
        mark("two_ranks")
    mark("end")
    emit(out)
    return out


def _feed_two_ranks(tmp: Path) -> dict:
    """launch:feed's 2-rank pairs on card 0 (gloo): --scheduled
    --prestage 3 against --prestage 0, and the prefetched plain run
    against --no-prefetch, at RESUME_ROWS rows, every launch at once:
    reports and checkpoints exact."""
    two = ["torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "herald_tpu_torch.launch", "--comm", "hybrid", "--device",
           "cuda:0", "--model", "wdl_criteo", "--bf16-table", "--rows",
           str(RESUME_ROWS), "--samples", "16384", "--scan-steps", "8",
           "--nepoch", "2"]
    sched = ["--scheduled", "--cache-limit-ratio", "0.25"]
    runs = {"prestage3": sched + ["--prestage", "3"],
            "prestage0": sched + ["--prestage", "0"],
            "prefetch": [], "no_prefetch": ["--no-prefetch"]}
    got = _on_threads({n: (lambda n=n, a=a: _feed_run(
        two + a + ["--ckpt", str(tmp / f"two-{n}")]))
        for n, a in runs.items()})
    out = {}
    for fed, direct in (("prestage3", "prestage0"),
                        ("prefetch", "no_prefetch")):
        a, b = got[fed][0], got[direct][0]
        if (a["devices"], a["backend"]) != (2, "gloo") \
                or _feed_untimed(a) != _feed_untimed(b) \
                or fed == "prefetch" and a["steps"] // 2 % 8 == 0:
            raise AssertionError(f"2 ranks: {fed} {a} against {direct} {b}")
        out[fed] = {"steps": a["steps"], "val_auc": a["val_auc"],
                    "checkpoints_equal": _same_ckpt(
                        tmp / f"two-{fed}", tmp / f"two-{direct}"),
                    "command_s": [got[fed][1], got[direct][1]]}
    return out


# ----------------------------------------------------------------------
# assign-only mode and the FAE engine at full width
# ----------------------------------------------------------------------

ASSIGNED_K = 32
FAE_SAMPLES, FAE_STEPS = 65536, 64
FAE_TRAIN = {"embedding_gather": 2, "hot_onehot_gather_add_": 1,
             "hot_onehot_push": 2, "unique_fill": 1}


def _launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


class _PlainCalls:
    """Counts the calls of every kernel's plain version while it is open:
    each `*_ref` function of the kernel modules is wrapped, so a wrapper
    that gave way to its plain version on the card would show here."""

    def __enter__(self):
        self.calls, self._saved = {}, []
        for mod in (k1_ops, k2_ops, k3_ops, k4_ops, k5_ops):
            for name, fn in list(vars(mod).items()):
                if name.endswith("_ref") and callable(fn):
                    self._saved.append((mod, name, fn))
                    setattr(mod, name, self._counted(name, fn))
        return self

    def _counted(self, name, fn):
        def call(*args, **kw):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*args, **kw)
        return call

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False


def phase_assigned(eng: Engine, state: TrainState) -> dict:
    """Assign-only mode at full width, in this process: the lookahead
    scheduler for one worker (csrc/herald_sched.cc built by the port; a
    cache of 10% of the rows, as the launcher sizes it) composes 128
    batches of synthetic_ctr_data(seed=0), and Engine.train_epoch_assigned
    trains them (SGD: K1 by position, K3, K2 with lr, one each a step).
    8 assigned steps are held against 8 plain steps over the same
    batches from a copy of the state: one device, so each step's samples
    are the plain step's in another order; losses within 1e-5
    (relative), touched rows within one bf16 ulp, dense params within
    1e-5. Then chunks of 32 steps, plain and assigned in turns (plain,
    assigned, assigned, plain), timed on the host clock from host arrays
    and ended by a readback of the last loss; the assigned chunks' launches
    are the path's counts."""
    from herald_tpu_torch.sched.scheduler import LookaheadScheduler
    B, K = eng.cfg.batch_size, ASSIGNED_K
    n_batches = 4 * K
    dense, sparse, labels = synthetic_ctr_data(
        eng.model.spec, n_batches * B, seed=0, num_rows=FULL_ROWS)
    t0 = time.perf_counter()
    sched = LookaheadScheduler(sparse, nrank=1, batch_size=B,
                               cache_size=eng.cfg.cache_rows(FULL_ROWS),
                               epochs=2, n_threads=eng.cfg.sched_threads)
    start_s = time.perf_counter() - t0
    try:
        # --- 8 steps against the plain steps on the same batches ---
        ref = TrainState(state.table.clone(), {},
                         {k: v.clone() for k, v in state.dense.items()},
                         {k: {} for k in state.dense}, state.step.clone())
        seen = []

        class Recorded:         # the scheduler, its assignments kept
            @staticmethod
            def pop():
                r = sched.pop()
                seen.append(r[0].reshape(-1).copy())
                return r

        state, got = eng.train_epoch_assigned(state, Recorded, dense,
                                              sparse, labels, steps=8)
        for i, idx in enumerate(seen):
            if sorted(idx.tolist()) != list(range(i * B, (i + 1) * B)):
                raise AssertionError(f"assigned batch {i} is not the plain "
                                     f"batch's samples")
        ref, want = eng.train_epoch(ref, dense, sparse, labels, steps=8)
        got_l, want_l = got["loss"].cpu(), want["loss"].cpu()
        loss_err = float(((got_l - want_l).abs() / want_l.abs()).max())
        touched = torch.as_tensor(np.unique(sparse[:8 * B]), device=DEVICE,
                                  dtype=torch.long)
        a = state.table[touched].float()
        b = ref.table[touched].float()
        rows_ok = torch.allclose(a, b, rtol=2 ** -7, atol=0)
        row_err = float((a - b).abs().max())
        identical = bool(torch.equal(state.table[touched],
                                     ref.table[touched]))
        dense_err = max(float((state.dense[k] - ref.dense[k]).abs().max())
                        for k in ref.dense)
        del ref, a, b
        _free()
        if loss_err > 1e-5 or dense_err > 1e-5 or not rows_ok:
            raise AssertionError(f"assigned steps differ from the plain "
                                 f"steps: loss {loss_err}, rows {row_err}, "
                                 f"dense {dense_err}")
        # --- timed, in turns; the assigned chunks' launches counted ---
        times = {"plain": [], "assigned": []}
        counts = dict.fromkeys(KERNELS, 0)
        lo = 8
        for mode in ("plain", "assigned", "assigned", "plain"):
            torch.cuda.synchronize()
            before = _launch_counts()
            t0 = time.perf_counter()
            if mode == "plain":
                s = slice(lo * B, (lo + K) * B)
                state, stats = eng.train_epoch(state, dense[s], sparse[s],
                                               labels[s], steps=K)
            else:
                state, stats = eng.train_epoch_assigned(
                    state, sched, dense, sparse, labels, steps=K)
            float(stats["loss"][-1])
            times[mode].append(time.perf_counter() - t0)
            if mode == "assigned":
                after = _launch_counts()
                for k in counts:
                    counts[k] += after[k] - before[k]
            else:
                lo += K
        launches = dict(counts)
        want = _want({"embedding_gather": 1, "hot_onehot_push": 1,
                      "rows_scatter_add": 1, "unique_fill": 1}, 2 * K)
        if launches != want:
            raise AssertionError(f"the assigned path launched {launches}; "
                                 f"expected {want}")
        perf = {**sched.perf(), "plan_time_us": sched.iter_time_us()}
    finally:
        sched.close()
    out = {"phase": "assigned", "model": eng.model.name, "batch": B,
           "table_shape": list(state.table.shape),
           "cache_size": eng.cfg.cache_rows(FULL_ROWS),
           "scheduler_start_s": start_s, "reference_steps": 8,
           "reference_loss_max_rel_err": loss_err,
           "reference_row_max_err": row_err,
           "reference_touched_rows_identical": identical,
           "reference_dense_max_err": dense_err,
           "chunk_steps": K, "chunk_s": times,
           "examples_per_s": {m: K * B / min(t) for m, t in times.items()},
           "launches": launches, "sched": perf}
    emit(out)
    return out, state


def reference_fae_step(eng, st, d, cold, hot_idx, y):
    """The FAE step through the plain versions on the card and the route
    the add form replaced: K1's on the unique cold ids, `[inv]`, widen;
    K4's gather, widen and `where`; K3's on the host, where `index_add_`
    adds in position order (the kernel's order for ids of at most 32
    positions; it adds longer segments in pieces of 32). The cold rows
    are updated in `st.table` (a compact table the caller indexes by
    remapped ids, -1 where hot) with the engine's optimizer."""
    from herald_tpu_torch.train.fae import FaeTrainState
    step = st.step + 1
    B, F = cold.shape
    W, dt = eng.width, st.table.dtype
    uniq, inv = torch.unique(cold.reshape(-1), sorted=True,
                             return_inverse=True)
    flat_hot = hot_idx.reshape(-1)
    emb = torch.where((flat_hot >= 0)[:, None],
                      hot_onehot_gather_ref(st.hot_table, flat_hot).float(),
                      embedding_gather_ref(st.table, uniq)[inv].float())
    loss, dgrads, g = eng._loss_and_grads(st.dense, emb.reshape(B, F, W),
                                          d, y)
    dense, dense_slots = eng.dense_opt.apply_dense(
        st.dense, dgrads, st.dense_slots, step, lr=eng._lr_fn(step))
    g = g.reshape(-1, W).cpu()
    g_uniq = hot_onehot_push_ref(inv.cpu(), g, uniq.numel()).to(
        st.table.device).to(dt)
    keep = uniq >= 0
    rows, _ = eng.embed_opt.apply_rows(
        embedding_gather_ref(st.table, uniq[keep]), g_uniq[keep], {}, step,
        lr=eng._elr_fn(step))
    st.table.index_copy_(0, uniq[keep].long(), rows.to(dt))
    g_hot = hot_onehot_push_ref(flat_hot.cpu(), g, eng.num_hot).to(
        st.table.device)
    hot, hot_slots = eng._apply_hot_grads(st.hot_table, st.hot_slots, step,
                                          g_hot)
    return FaeTrainState(st.table, {}, dense, dense_slots, step, hot,
                         hot_slots), loss.detach()


def phase_fae() -> dict:
    """The FAE engine at full width (bench.py:37-41): fae_wdl_criteo,
    batch 256, embedding 128, the 33,762,584 x 128 bf16 cold table and a
    hot block of 1% of the rows, 337,625 x 128 bf16, SGD at lr 0.01 on
    synthetic_ctr_data(seed=0) (65,536 samples), the hot-id LUT profiled
    from those ids. 8 steps held against the plain versions of K1, K3 and
    K4 on the card (`reference_fae_step`, a compact copy of the rows the
    steps touch): losses within 1e-5 (relative), touched cold rows and the
    hot block within one bf16 ulp, dense params within 1e-5, every other
    cold row with its bits. Then 64 steps timed, with their launches (K1
    by position and on the unique cold rows, K4's add form once, K3 twice
    a step) and the calls of every plain version (none); host waits over
    4 steps (none); a profile of 16 steps (device busy, idle share, K4's
    and K3's device ms a step); 8 steps on a copy of the whole state
    through the engine built with cuda_graphs=False, bit for bit and
    with the same launches; the dense hot update alone (device ms), K3
    at num_rows = H alone and timed as the kernels are (beside its plain
    version and zeros + index_add_); then evaluate_fae on 32 batches of
    seed 1."""
    from herald_tpu_torch.train.fae import (FaeEngine, FaeTrainState,
                                            build_hot_lut)
    cfg = HeraldConfig(model="fae_wdl_criteo", batch_size=BATCH,
                       embedding_dim=EMB, table_dtype=torch.bfloat16,
                       learning_rate=0.01)
    torch.cuda.reset_peak_memory_stats()
    eng = FaeEngine(cfg, table_rows=FULL_ROWS, device=DEVICE)
    state = eng.init_fae_state(0)
    H, W = eng.num_hot, eng.width
    if tuple(state.table.shape) != (33_762_584, EMB) or H != 337_625 \
            or tuple(state.hot_table.shape) != (H, EMB):
        raise AssertionError(f"FAE shapes {tuple(state.table.shape)}, "
                             f"{tuple(state.hot_table.shape)}")
    dense, sparse, labels = synthetic_ctr_data(
        eng.model.spec, FAE_SAMPLES, seed=0, num_rows=FULL_ROWS)
    t0 = time.perf_counter()
    lut, _ = build_hot_lut(sparse, FULL_ROWS, num_hot=H)
    lut_s = time.perf_counter() - t0
    hot_share = float((lut[sparse] >= 0).mean())
    B = BATCH

    def batch(i):
        s = slice(i * B, (i + 1) * B)
        return dense[s], sparse[s], labels[s]

    # --- 8 steps against the plain versions, from one state ---
    cold8, hot8 = eng.split_batch(lut, sparse[:8 * B])
    touched = torch.as_tensor(np.unique(cold8[cold8 >= 0]), device=DEVICE,
                              dtype=torch.long)
    before = _row_sums(state.table)
    ref = FaeTrainState(state.table[touched].clone(), {},
                        {k: v.clone() for k, v in state.dense.items()},
                        {k: {} for k in state.dense}, state.step.clone(),
                        state.hot_table.clone(), {})
    got_l, want_l = [], []
    for i in range(8):
        state, st = eng.train_step_fae(state, lut, *batch(i))
        s = slice(i * B, (i + 1) * B)
        cold = torch.as_tensor(cold8[s], device=DEVICE).long()
        local = torch.where(cold >= 0, torch.searchsorted(touched, cold),
                            -1).to(torch.int32)
        d, _, y = batch(i)
        ref, loss = reference_fae_step(
            eng, ref, torch.as_tensor(d, device=DEVICE, dtype=torch.float32),
            local, torch.as_tensor(hot8[s], device=DEVICE),
            torch.as_tensor(y, device=DEVICE, dtype=torch.float32))
        got_l.append(float(st["loss"]))
        want_l.append(float(loss))
    differ = before != _row_sums(state.table)
    differ[touched] = False
    if bool(differ.any()):
        raise AssertionError(f"{int(differ.sum())} cold rows no step "
                             f"touched changed")
    a, b = state.table[touched].float(), ref.table.float()
    ha, hb = state.hot_table.float(), ref.hot_table.float()
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(got_l, want_l))
    dense_err = max(float((state.dense[k] - ref.dense[k]).abs().max())
                    for k in ref.dense)
    cold_ok = torch.allclose(a, b, rtol=2 ** -7, atol=0)
    hot_ok = torch.allclose(ha, hb, rtol=2 ** -7, atol=0)
    reference = {
        "steps": 8, "loss_max_rel_err": loss_err,
        "cold_row_max_err": float((a - b).abs().max()),
        "cold_rows_identical": bool(torch.equal(state.table[touched],
                                                ref.table)),
        "hot_block_max_err": float((ha - hb).abs().max()),
        "hot_block_identical": bool(torch.equal(state.hot_table,
                                                ref.hot_table)),
        "dense_max_err": dense_err, "touched_cold_rows": int(touched.numel()),
        "tolerance": "loss 1e-5 relative; cold rows and hot block within "
                     "one bf16 ulp (rtol 2^-7); dense 1e-5; untouched cold "
                     "rows bit for bit"}
    del ref, a, b, ha, hb, differ, before
    _free()
    if loss_err > 1e-5 or dense_err > 1e-5 or not cold_ok or not hot_ok:
        raise AssertionError(f"the FAE steps differ from the plain-kernel "
                             f"reference: {reference}")

    # --- 64 steps timed, launches and plain-version calls counted ---
    for k in KERNELS.values():
        k.launches = 0
    lo = 8
    with _PlainCalls() as plain:
        t0 = time.perf_counter()
        for i in range(lo, lo + FAE_STEPS):
            state, st = eng.train_step_fae(state, lut, *batch(i))
        last = float(st["loss"])
        timed_s = time.perf_counter() - t0
    launches = _launch_counts()
    want = _want(FAE_TRAIN, FAE_STEPS)
    if launches != want or plain.calls:
        raise AssertionError(f"the FAE path launched {launches} (expected "
                             f"{want}) and called plain versions "
                             f"{plain.calls}")
    lo += FAE_STEPS
    if not np.isfinite(last):
        raise AssertionError("non-finite FAE loss")

    # --- host waits, the step profile, the hot update and K3 at H ---
    def step(i):
        nonlocal state
        state, _ = eng.train_step_fae(state, lut, *batch(lo + i))

    waits, sites = _count_host_waits(lambda: [step(i) for i in range(4)])
    _no_waits("fae", waits, sites)
    lo += 4
    busy, per, host, check = device_profile(step, 16, marker=HOT_ADD)
    lo += 17 * check["sessions"]

    # captured against uncaptured, from one state: 8 steps on a copy of
    # the whole state through the same engine built with cuda_graphs=False
    captured = None
    if GRAPHS:
        eager = FaeEngine(cfg, table_rows=FULL_ROWS, device=DEVICE,
                          cuda_graphs=False)
        twin = _tree(lambda t: t.clone(), state)
        got_l, twin_l, tally, tally_e = [], [], {}, {}
        for i in range(lo, lo + 8):
            state, st = _tallied(tally, lambda: eng.train_step_fae(
                state, lut, *batch(i)))
            twin, tst = _tallied(tally_e, lambda: eager.train_step_fae(
                twin, lut, *batch(i)))
            got_l.append(st["loss"])
            twin_l.append(tst["loss"])
        lo += 8
        captured = {"steps": 8, "losses_differ": _differ(got_l, twin_l),
                    "launches": tally, "uncaptured_launches": tally_e,
                    "state_differ": _differ(state, twin),
                    "graphs": eng.graphs.captures}
        del twin
        _free()
        if captured["losses_differ"] or captured["state_differ"]:
            raise AssertionError(f"captured FAE steps differ from "
                                 f"uncaptured: {captured}")
        _same_launches(captured)

    cold_b, hot_b = eng.split_batch(lut, sparse[lo * B:(lo + 1) * B])
    g = torch.randn((B * cold_b.shape[1], W), device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(8))
    hot_ids = torch.as_tensor(hot_b.reshape(-1), device=DEVICE)
    g_hot = hot_onehot_push(hot_ids, g, H)
    # the update alone, on a copy of the block (it writes its block)
    hot_copy = state.hot_table.clone()
    upd_busy, upd_per, _, _ = device_profile(
        lambda i: eng._apply_hot_grads(hot_copy, {}, state.step, g_hot), 16)
    del hot_copy
    k3_busy, k3_per, _, _ = device_profile(
        lambda i: hot_onehot_push(hot_ids, g, H), 16, marker="sum_segments")
    # K3 at FAE's hot-sum shape, as every kernel is timed: the hot ids of
    # 8 batches into H rows, beside its plain version and zeros +
    # index_add_ (into H + 1 rows, the cold positions sent to the last)
    hot8 = [torch.as_tensor(eng.split_batch(
        lut, sparse[(lo + j) * B:(lo + j + 1) * B])[1].reshape(-1),
        device=DEVICE) for j in range(8)]
    hot_sum = _push_timing(hot8, [H] * 8, W, drop=True)
    del hot8
    # the least the update must move: the bf16 block read and written
    # once, the f32 sum read once
    upd_bytes = H * W * (2 + 4 + 2)
    profile = {
        "device_busy_ms": busy, "host_ms_profiled": host,
        "device_idle_share": None if busy is None else 1 - busy / host,
        "hot_add_device_ms": _own_ms(per, HOT_ADD),
        "hot_onehot_push_device_ms": _k3_ms(per),
        "top_device_ms": _top(per),
        "profiler_sessions": check,
        "host_waits_per_step": waits / 4, "host_wait_sites": sites,
        "hot_update_device_ms": upd_busy,
        "hot_update_items_ms": upd_per,
        "hot_update_bound_ms": upd_bytes / HBM_BYTES_PER_S * 1e3,
        "hot_update_note": "apply_rows over all H rows in f32 (widen the "
                           "bf16 block, SGD, cast back); bound: the block "
                           "read and written once in bf16 and the f32 sum "
                           "read once",
        "hot_sum_alone_device_ms": k3_busy,
        "hot_sum_alone_k3_ms": _k3_ms(k3_per),
        "busy_gate": _busy_gate("fae", busy)}
    del g, g_hot
    # --- evaluate_fae on held-out batches ---
    dv, sv, yv = synthetic_ctr_data(eng.model.spec, 32 * B, seed=1,
                                    num_rows=FULL_ROWS)
    ev = eng.evaluate_fae(state, lut, dv, sv, yv)
    if not 0.0 <= ev["auc"] <= 1.0:
        raise AssertionError(f"evaluate_fae: {ev}")
    out = {"phase": "fae", "model": cfg.model, "batch": B,
           "table_shape": list(state.table.shape),
           "hot_shape": list(state.hot_table.shape),
           "table_dtype": str(state.table.dtype), "optimizer": "sgd",
           "lr": cfg.learning_rate, "samples": FAE_SAMPLES, "lut_s": lut_s,
           "hot_share": hot_share, "reference": reference,
           "steps_timed": FAE_STEPS, "timed_s": timed_s,
           "train_examples_per_s": FAE_STEPS * B / timed_s,
           "step_ms": timed_s / FAE_STEPS * 1e3, "launches": launches,
           "plain_version_calls": plain.calls, "loss_last": last,
           "step_profile": profile, "evaluate": ev,
           "captured_vs_uncaptured": captured, "hot_sum": hot_sum,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    return out


def phase_launch_fae() -> dict:
    """The launcher's FAE branch at full width, in a subprocess:
    `--model fae_wdl_criteo --bf16-table --rows 33762577` over 65,536
    samples (one epoch of 230 steps; the branch ignores --max-steps, as
    JAX's does). Its report must say mode "fae" and num_hot 337,625."""
    t0 = time.perf_counter()
    rep = _report(_run(["herald_tpu_torch.launch", "--model",
                        "fae_wdl_criteo", "--bf16-table", "--rows",
                        str(FULL_ROWS), "--samples", str(FAE_SAMPLES)]))
    command_s = time.perf_counter() - t0
    steps = (FAE_SAMPLES - int(FAE_SAMPLES * 0.1)) // BATCH
    if rep["mode"] != "fae" or rep["num_hot"] != 337_625 \
            or rep["steps"] != steps or len(rep["epochs"]) != 1 \
            or not np.isfinite(rep["train_loss_last"]) \
            or not 0.0 <= rep["val_auc"] <= 1.0:
        raise AssertionError(f"FAE launch report: {rep}")
    out = {"phase": "launch:fae", "command_s": command_s,
           "report": {k: rep[k] for k in (
               "model", "mode", "num_hot", "steps", "train_loss_last",
               "val_auc", "val_acc", "examples_per_sec", "timing",
               "device")}}
    emit(out)
    return out


def phase_launch_assigned() -> dict:
    """`--assign-only` in subprocesses: wdl_criteo at full width (96 steps
    over 65,536 samples, the scheduler's cache 10% of the rows), printing
    its `sched` counters; at 4,096 rows a run stopped at --max-steps and
    resumed with --resume (the scheduler fast-forwarded), whose final
    table and dense params must equal the uninterrupted run's bit for
    bit."""
    launch = ["herald_tpu_torch.launch", "--assign-only", "--model",
              "wdl_criteo", "--bf16-table"]
    t0 = time.perf_counter()
    full = _report(_run(launch + ["--rows", str(FULL_ROWS), "--samples",
                                  "65536", "--scan-steps", "32",
                                  "--max-steps", "96"]))
    full_s = time.perf_counter() - t0
    if full["mode"] != "assigned" or full["steps"] != 96 \
            or set(full["sched"]) != {"miss_pull", "miss_push",
                                      "update_pull", "update_push",
                                      "plan_time_us"} \
            or not np.isfinite(full["train_loss_last"]) \
            or not 0.0 <= full["val_auc"] <= 1.0:
        raise AssertionError(f"full-width assign-only report: {full}")
    rows = 4096
    small = launch + ["--rows", str(rows), "--samples", "8192",
                      "--scan-steps", "8", "--nepoch", "2", "--lr", "0.5"]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        whole = _report(_run(small + ["--ckpt", str(tmp / "whole")]))
        part = _report(_run(small + ["--ckpt", str(tmp / "part"),
                                     "--ckpt-every", "8", "--max-steps",
                                     "20"]))
        rest = _report(_run(small + ["--resume", str(tmp / "part"), "--ckpt",
                                     str(tmp / "rest")]))
        if part["steps"] != 20 or part["steps"] + rest["steps"] != \
                whole["steps"]:
            raise AssertionError(f"steps {part['steps']} + {rest['steps']} "
                                 f"!= {whole['steps']}")
        a = load_checkpoint(str(tmp / "whole"), DEVICE)
        b = load_checkpoint(str(tmp / "rest"), DEVICE)
        if int(a.step) != whole["steps"] or not torch.equal(a.table,
                                                            b.table) \
                or not all(torch.equal(a.dense[k], b.dense[k])
                           for k in a.dense):
            raise AssertionError("the resumed assign-only run's final state "
                                 "differs from the uninterrupted run's")
    out = {"phase": "launch:assigned", "full_width": {
        k: full[k] for k in ("mode", "steps", "train_loss_last", "val_auc",
                             "val_acc", "examples_per_sec", "sched",
                             "device")},
        "full_width_command_s": full_s, "rows_small": rows,
        "small_steps": whole["steps"], "resumed_at": part["steps"],
        "resume_bit_exact": True, "small_sched": whole["sched"]}
    emit(out)
    return out


# ----------------------------------------------------------------------
# DeepFM: dfm_criteo at batch 1024, embedding 512 over the full table
# (BASELINE.md:26-27, benchmarks/secondary_sweep.py:29), with K5
# ----------------------------------------------------------------------

DFM, DFM_BATCH, DFM_EMB = "dfm_criteo", 1024, 512
DFM_ITERS, DFM_EPOCHS = 64, 3
DFM_SERVE = {"embedding_gather": 1, "fm_second_order": 1}
DFM_TRAIN = {"embedding_gather": 1, "hot_onehot_push": 1,
             "rows_scatter_add": 1, "fm_second_order": 1,
             "fm_second_order_backward": 1}


def _fm_cases(views):
    """(label, emb) cases on the card: the shape of
    tests/test_pallas_kernels.py:39-46, a B no multiple of 128, the
    2nd-order view of [B, F, D+1] activations (storage offset 1), f32 and
    bf16, and the main path's own views."""
    g = torch.Generator(device=DEVICE).manual_seed(5)
    for dt in (torch.float32, torch.bfloat16):
        for B, F, D, fused in ((128, 26, 16, False), (130, 26, 16, False),
                               (130, 26, 16, True), (1000, 26, 512, True),
                               (3, 2, 700, True)):
            base = torch.randn((B, F, D + fused), generator=g,
                               device=DEVICE).to(dt)
            yield (f"{str(dt)[6:]} B={B} F={F} D={D}"
                   f"{' view of D+1' if fused else ''}",
                   base[:, :, 1:] if fused else base)
    for i in (0, len(views) - 1):
        yield f"main path: f32 view of dfm_criteo batch {i}", views[i]


def phase_kernel_fm(table: torch.Tensor, sparse: np.ndarray) -> tuple:
    """K5 forward and backward against their plain versions. Forward:
    within 1e-6 * sum_d (s_d^2 + q_d) per sample, two launches bit-equal.
    Backward: bit-exact against the plain version given the forward's s,
    two launches bit-equal, and within 1e-6 * |g| * max|s| per sample (one
    bf16 ulp more for bf16) of the plain version with s recomputed. Then
    timed at the training shape: the 2nd-order views of the f32 [1024, 26,
    513] activations of 8 batches of the full dfm_criteo table."""
    k = 8
    views = []
    for i in range(k):
        ids = torch.as_tensor(sparse[i * DFM_BATCH:(i + 1) * DFM_BATCH]
                              .astype(np.int32), device=DEVICE)
        act = embedding_gather(table, ids.reshape(-1)).reshape(
            DFM_BATCH, -1, table.shape[1]).float()
        views.append(act[:, :, 1:])
    cases, fwd_err, bwd_err = 0, 0.0, 0.0
    for label, v in _fm_cases(views):
        out, s = fm_second_order(v, return_s=True)
        want = fm_second_order_ref(v)
        e = v.float()
        scale = (e.sum(dim=1) ** 2 + (e * e).sum(dim=1)).sum(dim=1)
        err = (out - want).abs()
        if not bool((err <= 1e-6 * scale).all()):
            raise AssertionError(f"fm_second_order differs from its plain "
                                 f"version ({label}): max {float(err.max())}")
        if not torch.equal(out, fm_second_order(v)):
            raise AssertionError(f"fm_second_order is not deterministic "
                                 f"({label})")
        g = torch.randn(v.shape[0], device=DEVICE)
        grad = fm_second_order_backward(v, g, s)
        if not torch.equal(grad, fm_second_order_bwd_ref(v, g, s)) \
                or not torch.equal(grad, fm_second_order_backward(v, g, s)):
            raise AssertionError(f"fm_second_order_backward is not the "
                                 f"plain version bit for bit, or not "
                                 f"deterministic ({label})")
        want_g = fm_second_order_bwd_ref(v, g).float()
        gate = 1e-6 * (g.abs() * s.abs().amax(dim=1))[:, None, None]
        if v.dtype == torch.bfloat16:
            # one bf16 ulp: at most 2^-7 of the value's magnitude
            gate = gate + 2 ** -7 * want_g.abs()
        gerr = (grad.float() - want_g).abs()
        if not bool((gerr <= gate).all()):
            raise AssertionError(f"fm_second_order_backward differs from "
                                 f"its plain version with s recomputed "
                                 f"({label}): max {float(gerr.max())}")
        fwd_err = max(fwd_err, float(err.max()))
        bwd_err = max(bwd_err, float(gerr.max()))
        cases += 1
    torch.cuda.synchronize()

    B, F, D = views[0].shape
    g = torch.randn(B, device=DEVICE)
    ss = [fm_second_order(v, return_s=True)[1] for v in views]
    fns = {
        "fwd": (lambda i: fm_second_order(views[i % k]),
                lambda i: fm_second_order_ref(views[i % k])),
        "bwd": (lambda i: fm_second_order_backward(views[i % k], g,
                                                   ss[i % k]),
                lambda i: fm_second_order_bwd_ref(views[i % k], g,
                                                  ss[i % k]))}
    fwd_bytes = B * F * D * 4 + B * 4
    bwd_bytes = 2 * B * F * D * 4 + B * D * 4 + B * 4
    out = []
    for what, name, marker, nbytes, err in (
            ("fwd", "fm_second_order", "fm_forward", fwd_bytes, fwd_err),
            ("bwd", "fm_second_order_backward", "fm_backward", bwd_bytes,
             bwd_err)):
        kern, plain = fns[what]
        prof_k = device_profile(kern, k, marker=marker)
        prof_p = device_profile(plain, k)
        top_p = dict(sorted(prof_p[1].items(), key=lambda kv: -kv[1])[:4])
        out.append({"name": name, "cases": cases, "max_abs_err": err,
                    "shape": [B, F, D], "launches_per_shape": k,
                    "kernel_ms": cuda_ms(kern, k),
                    "plain_ms": cuda_ms(plain, k),
                    "library_ms": None, "library_device_ms": None,
                    "kernel_device_ms": _own_ms(prof_k[1], marker),
                    "plain_device_ms": prof_p[0],
                    "plain_top_device_ms": top_p,
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "bound_by": "bytes", "bytes_per_launch": nbytes})
    emit({"phase": "kernel:fm_second_order", "forward": out[0],
          "backward": out[1],
          "bound_note": "forward: emb read once, out written once; "
                        "backward: emb, s and g read once, grad written "
                        "once; 3 and 2 flops an element, far below the "
                        "f32 rate",
          "library_note": "none: no single PyTorch call computes this "
                          "function"})
    del views, ss
    return out[0], out[1]


def phase_launch_dfm() -> dict:
    """The entry point at the dfm configuration's full width, in a
    subprocess: the table built in its own process (free the parent's
    first), 96 steps in chunks of 8, the final evaluation and its report.
    Then a 4,096-row run's checkpoint served by `python -m
    herald_tpu_torch.serve`, equal to the Scorer on the restored state."""
    t0 = time.perf_counter()
    rep = _report(_run(["herald_tpu_torch.launch", "--model", DFM,
                        "--batch-size", str(DFM_BATCH), "--embedding-size",
                        str(DFM_EMB), "--bf16-table", "--rows",
                        str(FULL_ROWS), "--samples", "131072",
                        "--scan-steps", "8", "--max-steps", "96"]))
    command_s = time.perf_counter() - t0
    if rep["steps"] != 96 or rep["model"] != DFM \
            or not np.isfinite(rep["train_loss_last"]) \
            or not 0.0 <= rep["val_auc"] <= 1.0:
        raise AssertionError(f"dfm launch report: {rep}")
    # a 4,096-row run's checkpoint (513 wide) through the serve entry
    # point, against Engine.predict on the restored state
    rows = 4096
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        _run(["herald_tpu_torch.launch", "--model", DFM, "--batch-size",
              "64", "--embedding-size", str(DFM_EMB), "--bf16-table",
              "--rows", str(rows), "--samples", "4096", "--nepoch", "1",
              "--lr", "0.5", "--ckpt", str(tmp / "ckpt"), "--save-config",
              str(tmp / "cfg.json")])
        cfg = HeraldConfig.from_json((tmp / "cfg.json").read_text())
        eng = Engine(cfg, table_rows=rows, device=DEVICE)
        state = load_checkpoint(str(tmp / "ckpt"), DEVICE)
        assert tuple(state.table.shape) == (rows, DFM_EMB + 1)
        dense, sparse, _ = synthetic_ctr_data(eng.model.spec, 150, seed=3,
                                              num_rows=rows)
        want = Scorer(eng, state).score(dense, sparse)
        served = _served_by_entry_point(tmp / "ckpt", tmp / "cfg.json",
                                        rows, dense, sparse)
    if not np.array_equal(served, want):
        raise AssertionError(f"served dfm scores differ from the scorer by "
                             f"{np.abs(served - want).max()}")
    # the launcher's StepTimer leaves out its first 5 chunks of 8 steps:
    # the median of the other 7 is its steady step time
    out = {"phase": "launch:dfm", "command_s": command_s,
           "served_checkpoint_rows": rows, "served_equal_scorer": True,
           "steady_examples_per_s": 8 * DFM_BATCH
           / (rep["timing"]["p50_ms"] / 1e3),
           "report": {k: rep[k] for k in (
               "model", "steps", "train_loss_last", "val_auc", "val_acc",
               "examples_per_sec", "timing", "device")}}
    emit(out)
    return out


def phase_scheduled_dfm() -> dict:
    """CachedEngine at the dfm configuration's full width, tape mode
    (`_tape_run`): a cache of 10% of the rows (3,376,257 x 1,026 f32,
    13.9 GB), program widths from a host probe pass, 64 batches of
    synthetic_ctr_data (seed=0), DFM_EPOCHS counted epochs."""
    cfg, eng, data, probe_s = _sched_setup(0, DFM, DFM_BATCH, DFM_EMB,
                                           DFM_ITERS)
    out = {"phase": "scheduled:dfm", "probe_s": probe_s,
           "cache_rows": eng.cache_rows, "U_cap": eng.U_cap,
           "F_cap": eng.F_cap, "P_cap": eng.P_cap,
           "cache_gb": eng.cache_rows * 2 * eng.width * 4 / 1e9}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        out.update(_tape_run(eng, data, Path(tmp), DFM_ITERS, DFM_EPOCHS,
                             fm=True))
    _free()
    emit(out)
    return out


# ----------------------------------------------------------------------
# the row-sharded hybrid engine: two ranks sharing the card over gloo
# ----------------------------------------------------------------------

HYBRID_S, HYBRID_STEPS, HYBRID_TIMED = 2, 8, 64
# a hybrid SGD step's launches: K1 reads the owner's rows, the returned
# buffer by position, the send buffer of gradients and the rows updated;
# K3 sums the duplicate-id gradients and, on the owner, the received ones;
# the dedup of the rank's 6,656 ids is one unique_fill (the owner's of the
# 2 x 6,656 received slots, more than its capacity, is the library chain)
HYBRID_STEP = {"embedding_gather": 4, "hot_onehot_push": 2, "unique_fill": 1}
# the step's kernel calls in the order it makes them
HYBRID_SITES = (("embedding_gather", "owner_read"),
                ("embedding_gather", "by_position"),
                ("hot_onehot_push", "dup_sum"),
                ("embedding_gather", "send_grads"),
                ("hot_onehot_push", "owner_sum"),
                ("embedding_gather", "update_rows"))
# an FAE step over the ranks: the hybrid step's four K1 reads, K4's add
# form reading the hot rows into place, and K3 a third time, summing the
# hot gradients before their all-reduce
HYBRID_FAE_STEP = {"embedding_gather": 4, "hot_onehot_push": 3,
                   "hot_onehot_gather_add_": 1, "unique_fill": 1}
HYBRID_FAE_SITES = (("embedding_gather", "owner_read"),
                    ("embedding_gather", "by_position"),
                    ("hot_onehot_gather_add_", "hot_read"),
                    ("hot_onehot_push", "dup_sum"),
                    ("embedding_gather", "send_grads"),
                    ("hot_onehot_push", "owner_sum"),
                    ("embedding_gather", "update_rows"),
                    ("hot_onehot_push", "hot_sum"))
# FAE: timed steps, rank 0's profiled and recorded steps; assign-only:
# steps a turn and turns of assigned and plain chunks
HYBRID_FAE_TIMED, HYBRID_FAE_PROFILED = 16, 4
HYBRID_ASSIGNED_K, HYBRID_ASSIGNED_TURNS = 8, 3
# the cached step over the ranks: its kernel calls in the order it makes
# them, the flush's and the pull's only in a step that flushes or pulls
# (on any worker); its timed and profiled steps
HYBRID_SCHED_SITES = {
    "flush": (("embedding_gather", "flush_cache_rows"),
              ("embedding_gather", "flush_send"),
              ("hot_onehot_push", "flush_owner_sum"),
              ("embedding_gather", "flush_owner_rows")),
    "pull": (("embedding_gather", "pull_owner_read"),
             ("embedding_gather", "pull_by_position")),
    "step": (("embedding_gather", "cache_slots"),
             ("hot_onehot_gather_add_", "hot_read"),
             ("hot_onehot_push", "g_uniq"),
             ("hot_onehot_push", "hot_delta"))}
HYBRID_SCHED_TIMED, HYBRID_SCHED_PROFILED = 32, 4
# hybrid:checkpoint: steps trained from the saved and the restored state
HYBRID_CKPT_STEPS = 4


@contextlib.contextmanager
def _patched(repl: dict):
    """Module attributes replaced ({(module, name): fn}) while open."""
    saved = {key: getattr(*key) for key in repl}
    for (mod, name), fn in repl.items():
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def _hybrid_hooks(fns: dict) -> dict:
    """{(module, name): fn} for the names through which the hybrid steps
    call K1 (the engine, the exchange and the cached step), K3
    (ops.embedding, the FAE step's hot sum, the cached step's sums) and,
    given one, K4's add form (the FAE and cached steps' hot reads)."""
    from herald_tpu_torch.ops import embedding as emb_mod
    from herald_tpu_torch.parallel import exchange as ex_mod
    from herald_tpu_torch.train import cached as cached_mod
    from herald_tpu_torch.train import engine as eng_mod
    from herald_tpu_torch.train import fae as fae_mod
    hooks = {(ex_mod, "embedding_gather"): fns["embedding_gather"],
             (eng_mod, "embedding_gather"): fns["embedding_gather"],
             (cached_mod, "embedding_gather"): fns["embedding_gather"],
             (emb_mod, "hot_onehot_push"): fns["hot_onehot_push"],
             (fae_mod, "hot_onehot_push"): fns["hot_onehot_push"],
             (cached_mod, "hot_onehot_push"): fns["hot_onehot_push"]}
    if "hot_onehot_gather_add_" in fns:
        for mod in (fae_mod, cached_mod):
            hooks[(mod, "hot_onehot_gather_add_")] = \
                fns["hot_onehot_gather_add_"]
    return hooks


def _host_k3(ids, grads, num_rows, rows=None):
    """K3's plain version on the host, where `index_add_` adds in position
    order: the kernel's order for segments of at most 32 positions."""
    return hot_onehot_push_ref(ids.cpu(), grads.cpu(), num_rows,
                               None if rows is None else rows.cpu()).to(
        grads.device)


def _recording(calls: list, fae: bool = False, hooks=None) -> dict:
    """Hooks that append (kernel, args) of every K1 and K3 call (and K4
    add, with `fae`), the args cloned before the call but for the shard's
    table (read in place), then launch; placed by `hooks` (default the
    hybrid steps' `_hybrid_hooks`). Trailing None args (K3's `rows` off the
    multi-hot path) are the defaults, and are recorded and passed without."""
    def wrap(name, fn):
        def call(*args):
            while args and args[-1] is None:
                args = args[:-1]
            calls.append((name, [a.clone() if isinstance(a, torch.Tensor)
                                 and a.numel() * a.element_size() < 1 << 28
                                 else a for a in args]))
            return fn(*args)
        return call
    fns = {"embedding_gather": wrap("embedding_gather", embedding_gather),
           "hot_onehot_push": wrap("hot_onehot_push", hot_onehot_push)}
    if fae:
        fns["hot_onehot_gather_add_"] = wrap(
            "hot_onehot_gather_add_", k4_ops.hot_onehot_gather_add_)
    return (hooks or _hybrid_hooks)(fns)


def _hybrid_site_timing(name: str, inputs: list) -> dict:
    """One kernel site of the hybrid step, each launch on the inputs of
    another recorded step: held against the plain version (K1 bit for
    bit; K3 bit for bit on integer-valued grads at the recorded ids, and
    on the recorded grads within 1e-6 * sum|g| of each output element, as
    phase_kernel_push holds it), events and device time of kernel,
    plain version and library call, and the bound from what these inputs
    need. K1's library call is `index_select` (+ `.to(float32)` where the
    site widens) where every id lies in the table, else none (no single
    call zero-fills); K3's is zeros + `index_add_` of the grads widened to
    f32, the dropped positions sent to one extra row."""
    k = len(inputs)
    worst = 0.0
    if name == "hot_onehot_gather_add_":
        # into a copy of each recorded acc, bit for bit over the buffer;
        # timed as kernel:hot_onehot_gather times the add form
        for acc, hot, ids in inputs:
            got, want = acc.clone(), acc.clone()
            k4_ops.hot_onehot_gather_add_(got, hot, ids)
            k4_ops.hot_onehot_gather_add_ref(want, hot, ids)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError("hot_onehot_gather_add_ differs from "
                                     "its plain version at a hybrid site")
        t = _k4_timing(inputs[0][1], [a[2] for a in inputs],
                       inputs[0][0].clone())["add"]
        return {**t, "launches_timed": k, "max_abs_err": 0.0}
    if name == "embedding_gather":
        plain_fn, marker = embedding_gather_ref, K1
        tab, ids = inputs[0][0], inputs[0][1]
        od = inputs[0][2] if len(inputs[0]) > 2 else None
        for a in inputs:
            got, want = embedding_gather(*a), embedding_gather_ref(*a)
            if not torch.equal(got, want):
                raise AssertionError("embedding_gather differs from its "
                                     "plain version at a hybrid site")
        in_range = all(bool(((a[1] >= 0) & (a[1] < a[0].shape[0])).all())
                       for a in inputs)
        lib = None
        if in_range:
            def lib(t, i, o=None):
                out = torch.index_select(t, 0, i)
                return out if o is None else out.to(o)
        valid = [a[1][(a[1] >= 0) & (a[1] < a[0].shape[0])] for a in inputs]
        mean_u = sum(int(torch.unique(v).numel()) for v in valid) / k
        n = ids.numel()
        D = tab.shape[1]
        out_bytes = (od or tab.dtype).itemsize
        bytes_moved = (mean_u * D * tab.element_size() + n * D * out_bytes
                       + n * ids.element_size())
        shape = {"table_rows": tab.shape[0], "width": D, "ids": n,
                 "mean_distinct_rows": mean_u,
                 "out_dtype": str(od or tab.dtype).replace("torch.", "")}
    else:
        plain_fn, marker = hot_onehot_push_ref, "sum_segments"
        ids, grads, H = inputs[0]
        for a in inputs:
            # integer-valued grads at the recorded ids: exact sums
            gi = torch.randint(-8, 9, a[1].shape, device=a[1].device).to(
                a[1].dtype)
            if not torch.equal(hot_onehot_push(a[0], gi, a[2]),
                               hot_onehot_push_ref(a[0], gi, a[2])):
                raise AssertionError("hot_onehot_push differs from its "
                                     "plain version on integer grads at "
                                     "a hybrid site")
            err = (hot_onehot_push(*a) - hot_onehot_push_ref(*a)).abs()
            bound = 1e-6 * hot_onehot_push_ref(a[0], a[1].abs(), a[2])
            if not bool((err <= bound).all()):
                raise AssertionError(f"hot_onehot_push differs from its "
                                     f"plain version at a hybrid site "
                                     f"beyond 1e-6*sum|g| per element: max "
                                     f"{float(err.max())}")
            worst = max(worst, float(err.max()))
        lib_ids = [torch.where((a[0] >= 0) & (a[0] < a[2]), a[0], a[2])
                   for a in inputs]

        def lib(i, g, h, j=None):
            return torch.zeros((h + 1, g.shape[1]), device=g.device,
                               dtype=torch.float32).index_add_(
                0, j, g.to(torch.float32))
        kept = sum(int(((a[0] >= 0) & (a[0] < a[2])).sum())
                   for a in inputs) / k
        D = grads.shape[1]
        bytes_moved = (ids.numel() * ids.element_size()
                       + kept * D * grads.element_size() + H * D * 4)
        shape = {"positions": ids.numel(), "kept_positions": kept,
                 "num_rows": H, "width": D,
                 "grads_dtype": str(grads.dtype).replace("torch.", "")}
    fns = {"kernel": lambda i: (embedding_gather if marker == K1
                                else hot_onehot_push)(*inputs[i % k]),
           "plain": lambda i: plain_fn(*inputs[i % k])}
    if lib is not None:
        fns["library"] = (lambda i: lib(*inputs[i % k])) if marker == K1 \
            else (lambda i: lib(*inputs[i % k], j=lib_ids[i % k]))
    ev = {w: cuda_ms(f, k) for w, f in fns.items()}
    dev = {w: device_profile(f, k, marker if w == "kernel" else None)[0]
           for w, f in fns.items()}
    return {**shape, "launches_timed": k, "max_abs_err": worst,
            "kernel_ms": ev["kernel"], "plain_ms": ev["plain"],
            "library_ms": ev.get("library"),
            "kernel_device_ms": dev["kernel"],
            "plain_device_ms": dev["plain"],
            "library_device_ms": dev.get("library"),
            "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes_per_launch": bytes_moved}


def _movement(start, got, want) -> dict:
    """How touched rows moved from `start` in two runs: the elements that
    moved in `want`'s run and in `got`'s, and sum|moved_got - moved_want| /
    sum|moved_want|. At SGD lr 0.01 most bf16 elements of a row move less
    than half an ulp, so a check of the values alone would pass rows that
    were never updated."""
    s = start.float()
    mg, mw = got.float() - s, want.float() - s
    total = float(mw.abs().sum())
    return {"elements": mw.numel(), "moved": int((mw != 0).sum()),
            "moved_got": int((mg != 0).sum()),
            "move_err_ratio": float((mg - mw).abs().sum()) / total
            if total else None}


def _moved_ok(m: dict) -> bool:
    """Rows that moved, and moved as the reference's did, within 1%."""
    return m["moved"] > 0 and m["move_err_ratio"] is not None \
        and m["move_err_ratio"] <= 1e-2


def _hybrid_assigned_leg(eng: Engine, state: TrainState, data) -> tuple:
    """Assign-only mode over the ranks, on the hybrid phase's engine and
    state: rank 0 runs the launcher's lookahead scheduler for HYBRID_S
    workers over the first 8 + K*T global batches (a cache of 10% of the
    rows) and a BroadcastScheduler hands every rank each assignment. 8
    assigned steps (launches counted) and 8 plain steps over the same
    global batch sets, each from the same state (the rows those steps
    touch, the tower and the step restored); this rank's ids in each
    assigned step must be its row of the assignment, in order. Then T
    turns of K assigned and K plain steps, timed. Returns (the state,
    the leg's results)."""
    import torch.distributed as dist
    from herald_tpu_torch.sched.scheduler import LookaheadScheduler
    from herald_tpu_torch.sched.service import BroadcastScheduler
    comm, S = eng.comm, eng.num_shards
    dense, sparse, labels = data
    gb, K, T = S * BATCH, HYBRID_ASSIGNED_K, HYBRID_ASSIGNED_TURNS
    n = HYBRID_STEPS + K * T
    if len(sparse) < n * gb:
        raise ValueError(f"the assigned leg needs {n} global batches")
    sched = BroadcastScheduler(lambda: LookaheadScheduler(
        sparse[:n * gb], nrank=S, batch_size=BATCH,
        cache_size=eng.cfg.cache_rows(FULL_ROWS), epochs=1,
        n_threads=eng.cfg.sched_threads), comm, BATCH)
    touched = np.unique(sparse[:HYBRID_STEPS * gb])
    local = torch.as_tensor(touched[touched % S == comm.rank] // S,
                            device=comm.device)
    start = (state.table[local].clone(),
             {k: v.clone() for k, v in state.dense.items()},
             state.step.clone())

    def restore():
        state.table[local] = start[0]
        for k, v in start[1].items():
            state.dense[k].copy_(v)
        state.step.copy_(start[2])

    def batches(lo, k):
        z = slice(lo * gb, (lo + k) * gb)
        return dense[z], sparse[z], labels[z]

    restore()
    state, st = eng.train_epoch(state, *batches(0, HYBRID_STEPS))
    plain_l = st["loss"].cpu()
    restore()
    blocks, pops = [], []
    rank_block = eng._rank_block

    def recorded(x, dt, axis=0):
        out = rank_block(x, dt, axis)
        if dt == np.int32:
            blocks.append(out)
        return out

    class Recorded:
        def pop(self):
            r = sched.pop()
            if r is not None:
                pops.append(r[0])
            return r
    eng._rank_block = recorded
    for kern in KERNELS.values():
        kern.launches = 0
    try:
        state, st = eng.train_epoch_assigned(state, Recorded(), dense, sparse,
                                             labels, steps=HYBRID_STEPS)
    finally:
        del eng._rank_block
    launches = _launch_counts()
    asgn_l, overflow = st["loss"].cpu(), st["overflow"].cpu()
    want = np.stack([sparse[p[comm.rank]] for p in pops]).astype(np.int32)
    rank_rows_ok = len(blocks) == 1 and len(pops) == HYBRID_STEPS \
        and np.array_equal(blocks[0], want) and all(
            np.array_equal(np.sort(p.reshape(-1)),
                           np.arange(t * gb, (t + 1) * gb))
            for t, p in enumerate(pops))
    # T turns of K assigned steps and K plain steps (batches past the
    # assigned ones), both ranks from one barrier each
    secs = {"assigned": 0.0, "plain": 0.0}
    for t in range(T):
        for kind in ("assigned", "plain"):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "assigned":
                state, st = eng.train_epoch_assigned(
                    state, sched, dense, sparse, labels, steps=K)
            else:
                state, st = eng.train_epoch(
                    state, *batches(HYBRID_STEPS + t * K, K))
            float(st["loss"][-1])
            secs[kind] += time.perf_counter() - t0
    perf, plan_us = sched.perf(), sched.iter_time_us()
    sched.close()
    steps = K * T
    return state, {
        "steps": HYBRID_STEPS, "losses": asgn_l, "plain_losses": plain_l,
        "overflow": overflow, "launches": launches,
        "rank_rows_are_assignment_rows": bool(rank_rows_ok),
        "loss_max_rel_err": float(((asgn_l - plain_l).abs()
                                   / plain_l.abs()).max()),
        "timed_steps_each": steps,
        "assigned_examples_per_s": steps * gb / secs["assigned"],
        "plain_examples_per_s": steps * gb / secs["plain"],
        "assigned_over_plain": secs["plain"] / secs["assigned"],
        "assigned_step_ms": secs["assigned"] / steps * 1e3,
        "plain_step_ms": secs["plain"] / steps * 1e3,
        "plan_time_us": plan_us, "sched": perf}


def _hybrid_fae_leg(rank: int, tmp: Path) -> dict:
    """fae_wdl_criteo over the ranks at full width (batch 256 a rank, the
    bf16 cold table row-sharded, a replicated 337,625 x 128 bf16 hot
    block; SGD at lr 0.01, the hot-id LUT profiled from FAE_SAMPLES
    samples of seed 0, as phase_fae): this rank's init_fae_state(0)
    against the one-device engine's rows and hot block; 8 steps through
    the kernels (launches counted); the same 8 from the same state
    through the plain versions of K1, K3 and K4's add form; 16 timed
    steps; a profiled chunk (rank 0); steps whose kernel calls rank 0
    records and times at their eight sites; evaluate_fae on 8 global
    batches of seed 1. Writes the hot block after the 8 steps and at the
    end to DIR (bit-identical on every rank)."""
    import torch.distributed as dist
    from herald_tpu_torch.train.fae import FaeEngine, build_hot_lut
    S, gb, P = HYBRID_S, HYBRID_S * BATCH, HYBRID_FAE_PROFILED

    def config(**kw):
        return HeraldConfig(model="fae_wdl_criteo", embedding_dim=EMB,
                            table_dtype=torch.bfloat16, learning_rate=0.01,
                            **kw)
    eng = FaeEngine(config(batch_size=BATCH, comm_mode="hybrid"),
                    table_rows=FULL_ROWS, device=DEVICE + ":0")
    comm = eng.comm
    torch.cuda.reset_peak_memory_stats()
    one = FaeEngine(config(batch_size=gb), table_rows=FULL_ROWS,
                    device=comm.device)
    full = one.init_fae_state(0)
    state = eng.init_fae_state(0)
    n_mine = len(range(rank, FULL_ROWS, S))
    init_equal = bool(torch.equal(
        state.table[:n_mine], full.table[rank:FULL_ROWS:S])) and bool(
        torch.equal(state.hot_table, full.hot_table)) and all(
        torch.equal(state.dense[k], v) for k, v in full.dense.items())
    del full, one
    _free()
    dense, sparse, labels = synthetic_ctr_data(
        eng.model.spec, FAE_SAMPLES, seed=0, num_rows=FULL_ROWS)
    lut, _ = build_hot_lut(sparse, FULL_ROWS, num_hot=eng.num_hot)

    def steps(lo, k):
        nonlocal state
        out = []
        for i in range(lo, lo + k):
            z = slice(i * gb, (i + 1) * gb)
            state, st = eng.train_step_fae(state, lut, dense[z], sparse[z],
                                           labels[z])
            out.append(torch.stack([st["loss"], st["overflow"].float()]))
        return torch.stack(out).cpu()

    ids8 = sparse[:HYBRID_STEPS * gb]
    cold8 = ids8[lut[ids8] < 0]
    touched = np.unique(cold8)
    mine = touched[touched % S == rank]
    local = torch.as_tensor(mine // S, device=comm.device)
    start = (state.table[local].clone(),
             {k: v.clone() for k, v in state.dense.items()},
             state.hot_table.clone())
    for kern in KERNELS.values():
        kern.launches = 0
    res8 = steps(0, HYBRID_STEPS)
    launches = _launch_counts()
    rows, hot = state.table[local].clone(), state.hot_table.clone()
    dense_after = {k: v.clone() for k, v in state.dense.items()}
    # the same steps from the same state through the plain versions
    state.table[local] = start[0]
    for k, v in start[1].items():
        state.dense[k].copy_(v)
    state.hot_table.copy_(start[2])
    state.step.zero_()
    with _patched(_hybrid_hooks({
            "embedding_gather": embedding_gather_ref,
            "hot_onehot_push": _host_k3,
            "hot_onehot_gather_add_": k4_ops.hot_onehot_gather_add_ref})):
        p8 = steps(0, HYBRID_STEPS)
    p_rows, p_hot = state.table[local], state.hot_table
    losses, p_losses = res8[:, 0], p8[:, 0]
    plain = {
        "cold_rows": _movement(start[0], rows, p_rows),
        "hot_block": _movement(start[2], hot, p_hot),
        "losses_identical": bool(torch.equal(losses, p_losses)),
        "rows_identical": bool(torch.equal(rows, p_rows)),
        "hot_identical": bool(torch.equal(hot, p_hot)),
        "dense_identical": all(torch.equal(dense_after[k], state.dense[k])
                               for k in state.dense),
        "loss_max_rel_err": float(((losses - p_losses).abs()
                                   / p_losses.abs()).max()),
        "rows_within_one_ulp": bool(torch.allclose(
            rows.float(), p_rows.float(), rtol=2 ** -7, atol=0)),
        "hot_within_one_ulp": bool(torch.allclose(
            hot.float(), p_hot.float(), rtol=2 ** -7, atol=0)),
        "dense_max_err": max(float((dense_after[k] - state.dense[k]).abs()
                                   .max()) for k in state.dense)}
    plain["movement"] = _movement(torch.cat([start[0], start[2]]),
                                  torch.cat([rows, hot]),
                                  torch.cat([p_rows, p_hot]))
    torch.save(hot.cpu(), tmp / f"fae_hot8.r{rank}.pt")
    del p_rows, p_hot

    # timed steps, both ranks from one barrier
    lo = HYBRID_STEPS
    dist.barrier()
    torch.cuda.synchronize()
    sec0 = dict(comm.seconds)
    t0 = time.perf_counter()
    steps(lo, HYBRID_FAE_TIMED)
    timed_s = time.perf_counter() - t0
    comm_s = {k: v - sec0.get(k, 0.0) for k, v in comm.seconds.items()}
    lo += HYBRID_FAE_TIMED

    # one profiled chunk on rank 0
    sec0 = dict(comm.seconds)
    profile = None
    if rank == 0:
        prof, host_ms, lost = _session(lambda _i: steps(lo, P), 1)
        per, _ = _device_items(prof, P)
        host_ms /= P
        busy = None if lost else sum(per.values())
        ar = (comm.seconds["all_reduce"] - sec0["all_reduce"]) * 1e3 / P
        profile = {"steps": P, "device_busy_ms": busy,
                   "host_ms_profiled": host_ms,
                   "device_idle_share": None if busy is None
                   else 1 - busy / host_ms,
                   "embedding_gather_device_ms": _own_ms(per, K1),
                   "hot_add_device_ms": _own_ms(per, HOT_ADD),
                   "hot_onehot_push_device_ms": _k3_ms(per),
                   "all_reduce_host_ms": ar,
                   "all_reduce_share": ar / host_ms,
                   "all_to_all_host_ms": (comm.seconds["all_to_all"]
                                          - sec0["all_to_all"]) * 1e3 / P,
                   "top_device_ms": _top(per), "lost_launches": len(lost)}
    else:
        steps(lo, P)
    lo += P

    # the kernel calls of P steps, recorded on rank 0, then timed
    calls = []
    with _patched(_recording(calls, fae=True) if rank == 0 else {}):
        steps(lo, P)
    lo += P
    sites = None
    if rank == 0:
        per_step = len(HYBRID_FAE_SITES)
        if len(calls) != per_step * P or any(
                calls[i][0] != HYBRID_FAE_SITES[i % per_step][0]
                for i in range(len(calls))):
            raise AssertionError(f"the hybrid FAE step called "
                                 f"{[c[0] for c in calls[:per_step]]}")
        sites = {f"{kern}:{site}": _hybrid_site_timing(kern, [
            calls[i][1] for i in range(j, len(calls), per_step)])
            for j, (kern, site) in enumerate(HYBRID_FAE_SITES)}
    del calls
    dv, sv, yv = synthetic_ctr_data(eng.model.spec, 8 * gb, seed=1,
                                    num_rows=FULL_ROWS)
    ev = eng.evaluate_fae(state, lut, dv, sv, yv)
    torch.save(state.hot_table.cpu(), tmp / f"fae_hot_end.r{rank}.pt")
    dist.barrier()
    return {"mine": mine, "rows": rows.cpu(), "losses": losses,
            "overflow": res8[:, 1],
            "dense": {k: v.cpu() for k, v in dense_after.items()},
            "summary": {
                "init_equal": init_equal, "launches": launches,
                "plain_kernels": plain, "hot_share": float(
                    (lut[sparse] >= 0).mean()),
                "touched_cold_rows": int(local.numel()),
                "timed_steps": HYBRID_FAE_TIMED, "timed_s": timed_s,
                "comm_host_s": comm_s, "step_profile": profile,
                "sites": sites, "evaluate": ev,
                "hot_shape": list(state.hot_table.shape),
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}}


class _Hashed:
    """A planner whose every popped chunk leaves a sha256 of its arrays in
    `digests` (the ranks compare them: the same programs on every rank)."""

    def __init__(self, planner):
        self.planner, self.digests = planner, []

    def pop_chunk(self, steps):
        out = self.planner.pop_chunk(steps)
        h = hashlib.sha256(str(out[0]).encode())
        for a in out[1:]:
            h.update(np.ascontiguousarray(a).tobytes())
        self.digests.append(h.hexdigest())
        return out

    def __getattr__(self, name):
        return getattr(self.planner, name)


def _sched_sites(variants) -> list:
    """(kernel, site) of every kernel call of steps in these variants."""
    out = []
    for v in variants:
        out += (list(HYBRID_SCHED_SITES["flush"]) if v[0] else []) \
            + (list(HYBRID_SCHED_SITES["pull"]) if v[2] else []) \
            + list(HYBRID_SCHED_SITES["step"])
    return out


def _hybrid_scheduled_leg(rank: int, tmp: Path) -> dict:
    """wdl_criteo through CachedEngine over the ranks at full width (batch
    256 a rank, the bf16 table row-sharded, the default 10% cache of
    3,376,257 x 256 f32 rows a rank, a 4,096-row pinned tier over
    frequency-remapped ids, SGD at lr 0.01, staleness bound 0), rank 0
    planning for both workers through a BroadcastPlanner over exactly the
    leg's global batches (seed 0): the hot block against this rank's
    strided rows of [0, 4096); 8 gated steps in one chunk (launches
    counted, each step's phases kept); the same chunk from the same state
    (the cache and table rows it writes, the hot block, the tower, the
    step restored) through the plain versions of K1, K3 and K4's add form;
    HYBRID_SCHED_TIMED timed steps in chunks of 8; a profiled chunk (rank
    0); 8 steps whose kernel calls rank 0 records and times at their
    sites; the stream drained, sync_cache (the rows it flushes into this
    rank's block, before and after) and evaluate on 8 global batches of
    seed 1. Every chunk's arrays are hashed; the hot block and the tower
    go to DIR after the gated steps and at the end."""
    import torch.distributed as dist
    from herald_tpu_torch.sched.service import BroadcastPlanner
    S, gb, K, P = HYBRID_S, HYBRID_S * BATCH, HYBRID_STEPS, \
        HYBRID_SCHED_PROFILED
    n_steps = 2 * K + HYBRID_SCHED_TIMED + P
    cfg = HeraldConfig(model="wdl_criteo", batch_size=BATCH,
                       embedding_dim=EMB, table_dtype=torch.bfloat16,
                       learning_rate=0.01, comm_mode="hybrid",
                       use_cache=True, use_scheduler=True,
                       cache_limit_ratio=0.1, pinned_rows=PINNED)
    eng = CachedEngine(cfg, table_rows=FULL_ROWS, device=DEVICE + ":0")
    comm, C, W = eng.comm, eng.cache_rows, eng.width
    torch.cuda.reset_peak_memory_stats()
    dense, sparse, labels = synthetic_ctr_data(
        eng.model.spec, n_steps * gb, seed=0, num_rows=FULL_ROWS)
    sparse, _ = frequency_remap(sparse, FULL_ROWS)
    planner = _Hashed(BroadcastPlanner(
        lambda: eng.make_planner(sparse, epochs=1), comm,
        num_samples=len(sparse), nrank=S, batch_size=BATCH,
        unique_cap=eng.U_cap, flush_cap=eng.F_cap, cache_rows=C, epochs=1,
        prefetch_cap=eng.P_cap, num_tables=eng.model.spec.num_sparse))
    state = eng.init_cached_state(0)
    init_hot_ok = bool(torch.equal(state.table[:PINNED // S],
                                   state.hot_table[rank::S]))
    raw = (dense, sparse, labels)

    # --- 8 gated steps, then the same chunk through the plain versions
    out = planner.pop_chunk(K)
    staged = eng._stage_chunk(*out, *raw, index_feed=False)
    variants = staged.steps

    def mine(x):
        w = x.shape[1] // S
        return np.asarray(x[:K, rank * w:(rank + 1) * w])
    _, _, slots, _, fids, fslots, pfids, pfslots, uniq, _ = out
    sl, uq, ps, pi, fs = (mine(x) for x in (slots, uniq, pfslots, pfids,
                                            fslots))
    slots_w = np.unique(np.concatenate([
        sl[(uq >= 0) & (sl < C)], ps[(pi >= 0) & (ps < C)],
        fs[(fs >= 0) & (fs < C)]]))
    flushed = np.unique(np.asarray(fids[:K])[np.asarray(fids[:K]) >= 0])
    rows_w = flushed[flushed % S == rank] // S
    cs = torch.as_tensor(slots_w, device=comm.device)
    tr = torch.as_tensor(rows_w, device=comm.device)

    def snap():
        return (state.cache[cs].clone(), state.table[tr].clone(),
                state.hot_table.clone(),
                {k: v.clone() for k, v in state.dense.items()})
    start, step0 = snap(), state.step.clone()
    for kern in KERNELS.values():
        kern.launches = 0
    state, st = eng.train_epoch_staged(state, staged)
    launches = _launch_counts()
    losses, overflow = st["loss"].cpu(), st["overflow"].cpu()
    got = snap()
    torch.save({"hot": got[2].cpu(), "dense": {k: v.cpu() for k, v in
                                               got[3].items()}},
               tmp / f"sched8.r{rank}.pt")
    state.cache[cs] = start[0]
    state.table[tr] = start[1]
    state.hot_table.copy_(start[2])
    for k, v in start[3].items():
        state.dense[k].copy_(v)
    state.step.copy_(step0)
    with _patched(_hybrid_hooks({
            "embedding_gather": embedding_gather_ref,
            "hot_onehot_push": _host_k3,
            "hot_onehot_gather_add_": k4_ops.hot_onehot_gather_add_ref})):
        state, pst = eng.train_epoch_staged(state, staged)
    plain = snap()
    p_losses = pst["loss"].cpu()
    dscale = float(plain[0][:, W:].abs().max()) if len(slots_w) else 0.0
    check = {
        "losses_identical": bool(torch.equal(losses, p_losses)),
        "loss_max_rel_err": float(((losses - p_losses).abs()
                                   / p_losses.abs()).max()),
        "flushed_table_rows": int(rows_w.size),
        "written_cache_rows": int(slots_w.size),
        "rows_within_one_ulp": bool(torch.allclose(
            got[1].float(), plain[1].float(), rtol=2 ** -7, atol=0)),
        "hot_within_one_ulp": bool(torch.allclose(
            got[2].float(), plain[2].float(), rtol=2 ** -7, atol=0)),
        "value_plane_within_one_ulp": bool(torch.allclose(
            got[0][:, :W], plain[0][:, :W], rtol=2 ** -7, atol=0)),
        "delta_plane_max_err": float((got[0][:, W:] - plain[0][:, W:])
                                     .abs().max()) if len(slots_w) else 0.0,
        "delta_plane_scale": dscale,
        "dense_max_err": max(float((got[3][k] - plain[3][k]).abs().max())
                             for k in got[3]),
        "movement": _movement(torch.cat([start[1], start[2]]),
                              torch.cat([got[1], got[2]]),
                              torch.cat([plain[1], plain[2]]))}
    del start, got, plain, staged
    overflow_all = [overflow]

    # --- timed steps, both ranks from one barrier
    dist.barrier()
    torch.cuda.synchronize()
    sec0 = dict(comm.seconds)
    t0 = time.perf_counter()
    for _ in range(HYBRID_SCHED_TIMED // K):
        state, st = eng.train_epoch_cached(state, planner, *raw, steps=K)
        overflow_all.append(st["overflow"])
    float(st["loss"][-1])
    timed_s = time.perf_counter() - t0
    comm_s = {k: v - sec0.get(k, 0.0) for k, v in comm.seconds.items()}

    # --- one profiled chunk on rank 0
    holder = [state]

    def chunk(_i):
        holder[0], st = eng.train_epoch_cached(holder[0], planner, *raw,
                                               steps=P)
        overflow_all.append(st["overflow"])
    sec0 = dict(comm.seconds)
    profile = None
    if rank == 0:
        prof, host_ms, lost = _session(chunk, 1)
        per, _ = _device_items(prof, P)
        host_ms /= P
        busy = None if lost else sum(per.values())
        coll = {k: (v - sec0.get(k, 0.0)) * 1e3 / P
                for k, v in comm.seconds.items()}
        profile = {"steps": P, "device_busy_ms": busy,
                   "host_ms_profiled": host_ms,
                   "device_idle_share": None if busy is None
                   else 1 - busy / host_ms,
                   "embedding_gather_device_ms": _own_ms(per, K1),
                   "hot_add_device_ms": _own_ms(per, HOT_ADD),
                   "hot_onehot_push_device_ms": _k3_ms(per),
                   "collective_host_ms": coll,
                   "collective_share": sum(coll.values()) / host_ms,
                   "top_device_ms": _top(per), "lost_launches": len(lost)}
    else:
        chunk(0)
        torch.cuda.synchronize()
    state = holder[0]

    # --- the kernel calls of 8 steps, recorded on rank 0, then timed
    out = planner.pop_chunk(K)
    staged = eng._stage_chunk(*out, *raw, index_feed=False)
    calls = []
    with _patched(_recording(calls, fae=True) if rank == 0 else {}):
        state, st = eng.train_epoch_staged(state, staged)
    overflow_all.append(st["overflow"])
    sites = None
    if rank == 0:
        want = _sched_sites(staged.steps)
        if [c[0] for c in calls] != [k for k, _ in want]:
            raise AssertionError(f"the cached hybrid step called "
                                 f"{[c[0] for c in calls[:16]]}, expected "
                                 f"{[k for k, _ in want[:16]]}")
        by_site = {}
        for (kern, site), (_, args) in zip(want, calls):
            by_site.setdefault(f"{kern}:{site}", []).append(args)
        sites = {name: _hybrid_site_timing(name.split(":")[0], inputs)
                 for name, inputs in by_site.items()}
    del calls, staged

    # --- the end of the stream: sync_cache, evaluate
    drained = planner.pop_chunk(1)[0] == 0
    perf, plan_us = planner.perf(), planner.iter_time_us()
    dumps = [planner.dirty_rows(w) for w in range(S)]
    ids = np.unique(np.concatenate([d[0] for d in dumps]))
    synced = torch.as_tensor(ids[ids % S == rank] // S, device=comm.device)
    before = state.table[synced].clone()
    state = eng.sync_cache(state, planner)
    sync_moved = int((state.table[synced] != before).any(dim=1).sum())
    hot_written = bool(torch.equal(state.table[:PINNED // S],
                                   state.hot_table[rank::S]))
    dv, sv, yv = synthetic_ctr_data(eng.model.spec, 8 * gb, seed=1,
                                    num_rows=FULL_ROWS)
    ev = eng.evaluate(state, dv, sv, yv)
    planner.close()
    torch.save({"hot": state.hot_table.cpu(),
                "dense": {k: v.cpu() for k, v in state.dense.items()}},
               tmp / f"sched_end.r{rank}.pt")
    dist.barrier()
    return {"summary": {
        "digests": planner.digests, "variants": variants,
        "launches": launches, "expected_launches": _want_sched(variants),
        "losses": losses.tolist(), "plain_kernels": check,
        "overflow": int(sum(int(o.sum()) for o in overflow_all)),
        "init_hot_is_table_rows": init_hot_ok, "drained": drained,
        "timed_steps": HYBRID_SCHED_TIMED, "timed_s": timed_s,
        "comm_host_s": comm_s, "step_profile": profile, "sites": sites,
        "cache": {**perf, "plan_time_us": plan_us},
        "sync_rows": int(synced.numel()), "sync_rows_moved": sync_moved,
        "hot_written_back": hot_written, "evaluate": ev,
        "cache_rows": C, "U_cap": eng.U_cap, "F_cap": eng.F_cap,
        "flush_capacity": eng.flush_exchange.capacity,
        "pull_capacity": eng.exchange.capacity,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}}


def _want_sched(variants) -> dict:
    """The launches of cached steps in these variants: each kernel's count
    of `_sched_sites`, and none of the others."""
    want = {name: 0 for name in KERNELS}
    for kern, _ in _sched_sites(variants):
        want[kern] += 1
    return want


def _hybrid_checkpoint_leg(eng: Engine, state: TrainState, data,
                           tmp: Path) -> tuple:
    """hybrid:checkpoint on this rank: the plain state saved over the
    ranks (this rank's 16,881,296 x 128 bf16 block into its own shard
    file, rank 0 the tower and the manifest), restored into fresh
    tensors at S = 2, then HYBRID_CKPT_STEPS steps from the saved and
    from the restored state (rank 0 profiles the latter, its launches
    counted). Writes under the phase's directory in the build directory
    and deletes it. Returns (the state, the leg's results)."""
    comm = eng.comm
    ck = tmp / "ckpt"
    free_gb = shutil.disk_usage(tmp).free / 1e9
    comm.barrier()
    t0 = time.perf_counter()
    save_checkpoint(state, str(ck), comm=comm)
    save_s = time.perf_counter() - t0
    vdir = ck / f"v{int(state.step)}"
    mine = [f"shards.p{comm.rank}.npz", f"blocks.p{comm.rank}.json"] + (
        ["replicated.npz", "manifest.json"] if comm.rank == 0 else [])
    written = sum((vdir / f).stat().st_size for f in mine)
    comm.barrier()
    t0 = time.perf_counter()
    back = load_checkpoint(str(ck), comm.device, padded_rows=eng.padded_rows,
                           comm=comm)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    restored_equal = bool(torch.equal(back.table, state.table)) \
        and int(back.step) == int(state.step) \
        and all(torch.equal(back.dense[k], v) for k, v in state.dense.items())
    state, st = eng.train_epoch(state, *data)
    saved = (st["loss"].cpu(), _row_sums(state.table).cpu(),
             {k: v.clone() for k, v in state.dense.items()})
    run = {}

    def resumed(_i):
        run["state"], run["stats"] = eng.train_epoch(back, *data)
    for kern in KERNELS.values():
        kern.launches = 0
    profile = None
    comm.barrier()
    if comm.rank == 0:
        prof, host_ms, lost = _session(resumed, 1)
        per, _ = _device_items(prof, HYBRID_CKPT_STEPS)
        busy = None if lost else sum(per.values())
        profile = {"steps": HYBRID_CKPT_STEPS, "device_busy_ms": busy,
                   "host_ms_profiled": host_ms / HYBRID_CKPT_STEPS,
                   "top_device_ms": _top(per), "lost_launches": len(lost)}
    else:
        resumed(0)
        torch.cuda.synchronize()
    launches = _launch_counts()
    back = run.pop("state")
    identical = bool(torch.equal(run["stats"]["loss"].cpu(), saved[0])) \
        and bool(torch.equal(_row_sums(back.table).cpu(), saved[1])) \
        and all(torch.equal(back.dense[k], v) for k, v in saved[2].items())
    del back, run
    _free()
    comm.barrier()
    if comm.rank == 0:
        shutil.rmtree(ck)
    return state, {"rank": comm.rank, "free_gb_before": free_gb,
                   "bytes_written": written, "save_s": save_s,
                   "load_s": load_s, "save_gb_s": written / save_s / 1e9,
                   "load_gb_s": written / load_s / 1e9,
                   "restored_equal": restored_equal,
                   "steps_identical": identical,
                   "losses": saved[0].tolist(), "launches": launches,
                   "step_profile": profile}


def hybrid_rank(rank: int, tmp: Path) -> None:
    """One rank of the hybrid phase, in a process of its own on the card
    (`--hybrid-rank R --hybrid-dir DIR`): its own init_state(0), held
    against the strided rows and the tower of the one-device engine's
    init_state(0) (one seed, one logical table), then 8 steps through the
    kernels (their
    launches counted), the same 8 from the same state with the plain
    versions of K1 and K3, 64 timed steps, one profiled chunk of 8 (rank
    0), 8 steps whose K1 and K3 inputs rank 0 records and then times;
    then the checkpoint leg and the assign-only leg on the same engine,
    the FAE leg and the scheduled leg. Writes rank<R>.pt to DIR."""
    import torch.distributed as dist
    from herald_tpu_torch.parallel.comm import setup
    setup(DEVICE + ":0", init_method=f"file://{tmp}/store", rank=rank,
          world_size=HYBRID_S)
    cfg = HeraldConfig(model="wdl_criteo", batch_size=BATCH,
                       embedding_dim=EMB, table_dtype=torch.bfloat16,
                       comm_mode="hybrid")
    eng = Engine(cfg, table_rows=FULL_ROWS, device=DEVICE + ":0")
    comm = eng.comm
    gb = HYBRID_S * BATCH
    torch.cuda.reset_peak_memory_stats()
    one = Engine(HeraldConfig(model="wdl_criteo", batch_size=gb,
                              embedding_dim=EMB, table_dtype=torch.bfloat16),
                 table_rows=FULL_ROWS, device=comm.device)
    full = one.init_state(0)
    state = eng.init_state(0)
    n_mine = len(range(rank, FULL_ROWS, HYBRID_S))
    init_equal = bool(torch.equal(
        state.table[:n_mine], full.table[rank:FULL_ROWS:HYBRID_S])) and all(
        torch.equal(state.dense[k], v) for k, v in full.dense.items())
    del full, one
    _free()
    n = 2 * HYBRID_STEPS + HYBRID_TIMED
    dense, sparse, labels = synthetic_ctr_data(eng.model.spec, n * gb,
                                               seed=0, num_rows=FULL_ROWS)

    def batches(lo, k):
        z = slice(lo * gb, (lo + k) * gb)
        return dense[z], sparse[z], labels[z]

    touched = np.unique(sparse[:HYBRID_STEPS * gb])
    mine = touched[touched % HYBRID_S == rank]
    local = torch.as_tensor(mine // HYBRID_S, device=comm.device)
    start = (state.table[local].clone(),
             {k: v.clone() for k, v in state.dense.items()})

    for kern in KERNELS.values():
        kern.launches = 0
    state, st = eng.train_epoch(state, *batches(0, HYBRID_STEPS))
    launches = _launch_counts()
    losses, overflow = st["loss"].cpu(), st["overflow"].cpu()
    rows = state.table[local].clone()
    dense_after = {k: v.clone() for k, v in state.dense.items()}
    # the same steps from the same state through the plain versions
    state.table[local] = start[0]
    for k, v in start[1].items():
        state.dense[k].copy_(v)
    state.step.zero_()
    with _patched(_hybrid_hooks({"embedding_gather": embedding_gather_ref,
                                 "hot_onehot_push": _host_k3})):
        state, st = eng.train_epoch(state, *batches(0, HYBRID_STEPS))
    p_losses, p_rows = st["loss"].cpu(), state.table[local]
    plain = {
        **_movement(start[0], rows, p_rows),
        "losses_identical": bool(torch.equal(losses, p_losses)),
        "rows_identical": bool(torch.equal(rows, p_rows)),
        "dense_identical": all(torch.equal(dense_after[k], state.dense[k])
                               for k in state.dense),
        "loss_max_rel_err": float(((losses - p_losses).abs()
                                   / p_losses.abs()).max()),
        "rows_within_one_ulp": bool(torch.allclose(
            rows.float(), p_rows.float(), rtol=2 ** -7, atol=0)),
        "dense_max_err": max(float((dense_after[k] - state.dense[k]).abs()
                                   .max()) for k in state.dense)}

    # 64 timed steps, both ranks from one barrier
    dist.barrier()
    torch.cuda.synchronize()
    sec0 = dict(comm.seconds)
    t0 = time.perf_counter()
    state, st = eng.train_epoch(state, *batches(HYBRID_STEPS, HYBRID_TIMED))
    float(st["loss"][-1])
    timed_s = time.perf_counter() - t0
    comm_s = {k: v - sec0.get(k, 0.0) for k, v in comm.seconds.items()}

    # one chunk of 8 steps profiled on rank 0
    holder = [state]
    prof_batches = batches(HYBRID_STEPS + HYBRID_TIMED, HYBRID_STEPS)

    def chunk(_i):
        holder[0], _ = eng.train_epoch(holder[0], *prof_batches)

    sec0 = dict(comm.seconds)
    profile = None
    if rank == 0:
        prof, host_ms, lost = _session(chunk, 1)
        per, _ = _device_items(prof, HYBRID_STEPS)
        host_ms /= HYBRID_STEPS
        busy = None if lost else sum(per.values())
        a2a = (comm.seconds["all_to_all"] - sec0["all_to_all"]) * 1e3 \
            / HYBRID_STEPS
        profile = {"steps": HYBRID_STEPS, "device_busy_ms": busy,
                   "host_ms_profiled": host_ms,
                   "device_idle_share": None if busy is None
                   else 1 - busy / host_ms,
                   "embedding_gather_device_ms": _own_ms(per, K1),
                   "hot_onehot_push_device_ms": _k3_ms(per),
                   "all_to_all_host_ms": a2a,
                   "all_to_all_share": a2a / host_ms,
                   "all_reduce_host_ms": (comm.seconds["all_reduce"]
                                          - sec0["all_reduce"]) * 1e3
                   / HYBRID_STEPS,
                   "top_device_ms": _top(per), "lost_launches": len(lost)}
    else:
        chunk(0)
        torch.cuda.synchronize()
    state = holder[0]

    # the K1 and K3 inputs of 8 steps, recorded on rank 0, then timed
    calls = []
    with _patched(_recording(calls) if rank == 0 else {}):
        state, _ = eng.train_epoch(state, *batches(0, HYBRID_STEPS))
    sites = None
    if rank == 0:
        per_step = len(HYBRID_SITES)
        if len(calls) != per_step * HYBRID_STEPS or any(
                calls[i][0] != HYBRID_SITES[i % per_step][0]
                for i in range(len(calls))):
            raise AssertionError(f"the hybrid step called "
                                 f"{[c[0] for c in calls[:per_step]]}")
        sites = {f"{kern}:{site}": _hybrid_site_timing(kern, [
            calls[i][1] for i in range(j, len(calls), per_step)])
            for j, (kern, site) in enumerate(HYBRID_SITES)}
    dist.barrier()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    table_shape = list(state.table.shape)
    # the plain state saved and restored, over the ranks (the profiled
    # chunk's first batches)
    state, ckpt = _hybrid_checkpoint_leg(
        eng, state, batches(HYBRID_STEPS + HYBRID_TIMED, HYBRID_CKPT_STEPS),
        tmp)
    # assign-only mode on the same engine, then the FAE engine
    state, assigned = _hybrid_assigned_leg(eng, state, batches(0, n))
    del state, eng
    _free()
    fae = _hybrid_fae_leg(rank, tmp)
    _free()
    sched = _hybrid_scheduled_leg(rank, tmp)
    torch.save({"mine": mine, "rows": rows.cpu(), "losses": losses,
                "overflow": overflow,
                "dense": {k: v.cpu() for k, v in dense_after.items()},
                "assigned": assigned, "fae": fae, "scheduled": sched,
                "checkpoint": ckpt, "summary": {
                    "rank": rank, "backend": comm.backend,
                    "world_size": comm.size, "init_equal": init_equal,
                    "launches": launches, "plain_kernels": plain,
                    "timed_steps": HYBRID_TIMED, "timed_s": timed_s,
                    "comm_host_s": comm_s, "step_profile": profile,
                    "sites": sites, "table_shape": table_shape,
                    "peak_mem_gb": peak_gb}},
               tmp / f"rank{rank}.pt")
    dist.destroy_process_group()


def phase_hybrid() -> dict:
    """wdl_criteo at full width (batch 256 a rank, the 33,762,577-row bf16
    table row-sharded: 16,881,296 rows, 4.32 GB a rank) trained by
    HYBRID_S ranks on this card over gloo, each a process of its own
    (`hybrid_rank`, with a timeout). Gates: 8 steps against the
    one-device engine (batch 512) from the same logical state over the
    same global batches, run here after the ranks exit: losses within
    rtol 1e-5, overflow 0, every touched row within 2^-7 of its value
    plus 2^-13 and the dense params within rtol 1e-4, atol 1e-6 (the
    tolerances of tests/test_torch_hybrid.py); the same 8 steps through
    the plain versions of K1 and K3: losses within 1e-5 relative, rows
    within one bf16 ulp, dense within 1e-5 (train's gates). In both, the
    touched rows' movement from the start (`_movement`): some element
    moved, and the hybrid rows' movement is within 1% of the reference's
    (summed over the elements). Each rank's own init_state(0) is the
    one-device engine's, and each step launches HYBRID_STEP. Then 64
    timed steps (global examples/s), rank 0's step profile and the six
    kernel sites timed at their shapes. The same ranks then run the
    checkpoint, assign-only, FAE and scheduled legs
    (`_hybrid_checkpoint_leg`, `_hybrid_assigned_leg`, `_hybrid_fae_leg`,
    `_hybrid_scheduled_leg`), held here by `_hybrid_checkpoint_gates`,
    `_hybrid_assigned_gates`, `_hybrid_fae_gates` and
    `_hybrid_scheduled_gates`, each emitted as a line of its own."""
    _free()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        logs = [open(tmp / f"rank{r}.log", "w") for r in range(HYBRID_S)]
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--hybrid-rank",
             str(r), "--hybrid-dir", str(tmp)], cwd=ROOT, stdout=logs[r],
            stderr=subprocess.STDOUT) for r in range(HYBRID_S)]
        try:
            for r, p in enumerate(procs):
                p.wait(timeout=max(1.0, 600 - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        ranks_s = time.perf_counter() - t0
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise AssertionError(
                    f"hybrid rank {r} exited {p.returncode}:\n"
                    f"{(tmp / f'rank{r}.log').read_text()[-4000:]}")
        res = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
               for r in range(HYBRID_S)]
        fae_hot = [[torch.load(tmp / f"fae_hot{when}.r{r}.pt")
                    for r in range(HYBRID_S)] for when in ("8", "_end")]
        sched_saved = {when: [torch.load(tmp / f"sched{f}.r{r}.pt")
                              for r in range(HYBRID_S)]
                       for when, f in (("after the gated steps", "8"),
                                       ("at the end", "_end"))}
    summ = [r["summary"] for r in res]
    want_launches = _want(HYBRID_STEP, HYBRID_STEPS)
    for s in summ:
        if s["backend"] != "gloo" or s["world_size"] != HYBRID_S:
            raise AssertionError(f"rank {s['rank']}: {s['backend']} over "
                                 f"{s['world_size']} ranks")
        if s["launches"] != want_launches:
            raise AssertionError(f"rank {s['rank']} launched "
                                 f"{s['launches']}; expected "
                                 f"{want_launches}")
        if not s["init_equal"]:
            raise AssertionError(f"rank {s['rank']}'s init_state(0) is not "
                                 f"its block of the one-device engine's")
        p = s["plain_kernels"]
        if p["loss_max_rel_err"] > 1e-5 or not p["rows_within_one_ulp"] \
                or p["dense_max_err"] > 1e-5 or not _moved_ok(p):
            raise AssertionError(f"rank {s['rank']}'s steps differ from "
                                 f"the plain versions of K1 and K3: {p}")
    if any(not torch.equal(r["losses"], res[0]["losses"]) for r in res) \
            or any(int(r["overflow"].sum()) for r in res):
        raise AssertionError("the ranks' losses differ or overflowed")

    # the one-device engine over the same global batches, same state
    gb = HYBRID_S * BATCH
    one = Engine(HeraldConfig(model="wdl_criteo", batch_size=gb,
                              embedding_dim=EMB, table_dtype=torch.bfloat16),
                 table_rows=FULL_ROWS, device=DEVICE)
    st = one.init_state(0)
    n = 2 * HYBRID_STEPS + HYBRID_TIMED
    dense, sparse, labels = synthetic_ctr_data(one.model.spec, n * gb,
                                               seed=0, num_rows=FULL_ROWS)
    z = slice(0, HYBRID_STEPS * gb)
    mine = [torch.as_tensor(r["mine"], device=DEVICE) for r in res]
    start = [st.table[m].clone() for m in mine]
    st, stats = one.train_epoch(st, dense[z], sparse[z], labels[z])
    want_l = stats["loss"].cpu()
    got_l = res[0]["losses"]
    loss_err = float(((got_l - want_l).abs() / want_l.abs()).max())
    row_err, dense_err, rows_ok = 0.0, 0.0, True
    moves = []
    for r, m, s0 in zip(res, mine, start):
        want_rows = st.table[m]
        a, b = r["rows"].to(DEVICE).float(), want_rows.float()
        row_err = max(row_err, float((a - b).abs().max()))
        rows_ok &= bool(torch.allclose(a, b, rtol=2 ** -7, atol=2 ** -13))
        moves.append(_movement(s0, r["rows"].to(DEVICE), want_rows))
        rows_ok &= _moved_ok(moves[-1])
    for k, v in res[0]["dense"].items():
        dense_err = max(dense_err, float((v - st.dense[k].cpu()).abs().max()))
        rows_ok &= bool(torch.allclose(v, st.dense[k].cpu(), rtol=1e-4,
                                       atol=1e-6))
    touched = sum(len(r["mine"]) for r in res)
    del st, one, start
    _free()
    if loss_err > 1e-5 or not rows_ok:
        raise AssertionError(f"the hybrid steps differ from the one-device "
                             f"engine's: loss {loss_err}, rows {row_err}, "
                             f"dense {dense_err}, movement {moves}")
    checkpoint = _hybrid_checkpoint_gates(res, summ[0]["step_profile"])
    assigned = _hybrid_assigned_gates(res)
    fae = _hybrid_fae_gates(res, fae_hot)
    scheduled = _hybrid_scheduled_gates(res, sched_saved)
    timed = max(s["timed_s"] for s in summ)
    out = {"phase": "hybrid", "model": "wdl_criteo",
           "backend": summ[0]["backend"], "world_size": HYBRID_S,
           # gloo takes the CUDA tensors of every collective this phase
           # makes and copies them through host memory itself;
           # parallel/comm.py stages nothing of its own
           "staged_through_host": False,
           "init_equal_one_device": True,
           "batch_per_rank": BATCH, "global_batch": gb,
           "table_shape_per_rank": summ[0]["table_shape"],
           "ranks_command_s": ranks_s,
           "losses": got_l.tolist(), "overflow": 0,
           "one_device": {"steps": HYBRID_STEPS, "touched_rows": touched,
                          "loss_max_rel_err": loss_err,
                          "row_max_err": row_err,
                          "row_movement": moves,
                          "dense_max_err": dense_err},
           "plain_kernels": [s["plain_kernels"] for s in summ],
           "launches": summ[0]["launches"],
           "train_examples_per_s": HYBRID_TIMED * gb / timed,
           "step_ms": timed / HYBRID_TIMED * 1e3,
           "comm_host_s_timed": [s["comm_host_s"] for s in summ],
           "step_profile": summ[0]["step_profile"],
           "kernel_sites": summ[0]["sites"],
           "peak_mem_gb": [s["peak_mem_gb"] for s in summ]}
    emit(out)
    emit(checkpoint)
    emit(assigned)
    emit(fae)
    emit(scheduled)
    return {**out, "checkpoint": checkpoint, "assigned": assigned, "fae": fae,
            "scheduled": scheduled}


def _hybrid_checkpoint_gates(res, hybrid_profile) -> dict:
    """hybrid:checkpoint over the ranks: every rank's restore equal to
    what it saved (table, tower, step), the steps from the saved and from
    the restored state bit-identical (losses, the table's row
    fingerprints, the tower) and equal on every rank, HYBRID_STEP
    launches a restored step. Prints each rank's bytes written, save and
    load seconds and GB/s, and rank 0's busy a restored step beside the
    hybrid leg's."""
    ck = [r["checkpoint"] for r in res]
    want = _want(HYBRID_STEP, HYBRID_CKPT_STEPS)
    for c in ck:
        if not (c["restored_equal"] and c["steps_identical"]):
            raise AssertionError(f"rank {c['rank']}'s restored state or "
                                 f"its steps differ from the saved one's: "
                                 f"{c}")
        if c["launches"] != want:
            raise AssertionError(f"rank {c['rank']}'s restored steps "
                                 f"launched {c['launches']}; expected "
                                 f"{want}")
    if any(c["losses"] != ck[0]["losses"] for c in ck):
        raise AssertionError("the ranks' losses after the restore differ")
    prof = ck[0]["step_profile"]
    busy, busy0 = prof["device_busy_ms"], hybrid_profile["device_busy_ms"]
    return {"phase": "hybrid:checkpoint", "model": "wdl_criteo",
            "world_size": HYBRID_S,
            "table_shape_per_rank": res[0]["summary"]["table_shape"],
            "rows_cut": None, "steps_after_restore": HYBRID_CKPT_STEPS,
            "restored_equal": True, "steps_bit_identical": True,
            "launches": ck[0]["launches"],
            "per_rank": [{k: c[k] for k in (
                "rank", "bytes_written", "save_s", "load_s", "save_gb_s",
                "load_gb_s", "free_gb_before")} for c in ck],
            "losses": ck[0]["losses"], "step_profile": prof,
            "busy_over_hybrid_step": None if busy is None or busy0 is None
            else busy / busy0}


def _hybrid_assigned_gates(res) -> dict:
    """assign-only over the ranks: HYBRID_STEP launches a step, rank r's
    ids the assignment's row r, the losses of the plain steps over the
    same global batch sets within rtol 1e-5 (tests/test_assigned.py's
    invariant) and equal on every rank, no overflow."""
    asg = [r["assigned"] for r in res]
    want = _want(HYBRID_STEP, HYBRID_STEPS)
    brief = ("losses", "plain_losses", "overflow")
    for r, a in enumerate(asg):
        if a["launches"] != want or not a["rank_rows_are_assignment_rows"] \
                or a["loss_max_rel_err"] > 1e-5 or int(a["overflow"].sum()):
            raise AssertionError(
                f"rank {r}'s assigned steps: "
                f"{ {k: v for k, v in a.items() if k not in brief} }; "
                f"expected launches {want}")
    if any(not torch.equal(a["losses"], asg[0]["losses"]) for a in asg):
        raise AssertionError("the ranks' assigned losses differ")
    a = asg[0]
    return {"phase": "hybrid:assigned", "model": "wdl_criteo",
            "world_size": HYBRID_S, "global_batch": HYBRID_S * BATCH,
            "losses": a["losses"].tolist(),
            "plain_losses": a["plain_losses"].tolist(),
            **{k: v for k, v in a.items() if k not in brief},
            "ranks_assigned_over_plain": [x["assigned_over_plain"]
                                          for x in asg]}


def _still_or_moved_ok(m: dict) -> bool:
    """Rows that moved as the reference's did (`_moved_ok`), or that
    moved in neither run: a rare cold id's update at lr 0.01 may stay
    under half a bf16 ulp in both."""
    return _moved_ok(m) or (m["moved"] == 0 and m["moved_got"] == 0)


def _hybrid_fae_gates(res, fae_hot) -> dict:
    """The FAE leg: each rank's init_fae_state(0) the one-device engine's
    rows and hot block, HYBRID_FAE_STEP launches a step, the plain
    versions' steps within train's gates (losses 1e-5 relative, cold rows
    and hot block within one bf16 ulp, dense 1e-5, the movement of the
    touched cold rows and the hot block together within 1%), the hot
    block bit-identical on every rank after the 8 steps and at the end;
    then the one-device FaeEngine (batch 512) over the same global
    batches from one logical state, after the ranks exit: losses within
    rtol 1e-5, overflow 0, every touched cold row and the hot block
    within 2^-7 of the value plus 2^-13, dense within rtol 1e-4, atol
    1e-6, and the movement of the touched rows (cold and hot together)
    within 1% summed, the cold rows alone moving as the reference's or,
    with it, not at all."""
    from herald_tpu_torch.train.fae import FaeEngine, build_hot_lut
    fres = [r["fae"] for r in res]
    fsum = [f["summary"] for f in fres]
    want = _want(HYBRID_FAE_STEP, HYBRID_STEPS)
    for r, f in enumerate(fsum):
        p = f["plain_kernels"]
        if f["launches"] != want or not f["init_equal"]:
            raise AssertionError(f"FAE rank {r} launched {f['launches']} "
                                 f"(expected {want}), init equal: "
                                 f"{f['init_equal']}")
        if p["loss_max_rel_err"] > 1e-5 or not p["rows_within_one_ulp"] \
                or not p["hot_within_one_ulp"] or p["dense_max_err"] > 1e-5 \
                or not _moved_ok(p["movement"]) \
                or not _still_or_moved_ok(p["cold_rows"]):
            raise AssertionError(f"FAE rank {r}'s steps differ from the "
                                 f"plain versions of K1, K3 and K4: {p}")
    for when, blocks in zip(("after 8 steps", "at the end"), fae_hot):
        if any(not torch.equal(b, blocks[0]) for b in blocks):
            raise AssertionError(f"the ranks' hot blocks differ {when}")
    if any(not torch.equal(f["losses"], fres[0]["losses"]) for f in fres) \
            or any(int(f["overflow"].sum()) for f in fres):
        raise AssertionError("the ranks' FAE losses differ or overflowed")

    gb = HYBRID_S * BATCH
    one = FaeEngine(HeraldConfig(model="fae_wdl_criteo", batch_size=gb,
                                 embedding_dim=EMB,
                                 table_dtype=torch.bfloat16,
                                 learning_rate=0.01),
                    table_rows=FULL_ROWS, device=DEVICE)
    st = one.init_fae_state(0)
    dense, sparse, labels = synthetic_ctr_data(
        one.model.spec, FAE_SAMPLES, seed=0, num_rows=FULL_ROWS)
    lut, _ = build_hot_lut(sparse, FULL_ROWS, num_hot=one.num_hot)
    mine = [torch.as_tensor(f["mine"], device=DEVICE) for f in fres]
    start = [st.table[m].clone() for m in mine]
    hot0 = st.hot_table.clone()
    want_l = []
    for i in range(HYBRID_STEPS):
        z = slice(i * gb, (i + 1) * gb)
        st, stats = one.train_step_fae(st, lut, dense[z], sparse[z],
                                       labels[z])
        want_l.append(stats["loss"])
    want_l = torch.stack(want_l).cpu()
    got_l = fres[0]["losses"]
    loss_err = float(((got_l - want_l).abs() / want_l.abs()).max())
    ok, row_err = True, 0.0
    got_rows, want_rows = [], []
    for f, m in zip(fres, mine):
        a, b = f["rows"].to(DEVICE), st.table[m]
        row_err = max(row_err, float((a.float() - b.float()).abs().max()))
        ok &= bool(torch.allclose(a.float(), b.float(), rtol=2 ** -7,
                                  atol=2 ** -13))
        got_rows.append(a)
        want_rows.append(b)
    hot = fae_hot[0][0].to(DEVICE)
    hot_err = float((hot.float() - st.hot_table.float()).abs().max())
    ok &= bool(torch.allclose(hot.float(), st.hot_table.float(),
                              rtol=2 ** -7, atol=2 ** -13))
    cold = _movement(torch.cat(start), torch.cat(got_rows),
                     torch.cat(want_rows))
    hot_m = _movement(hot0, hot, st.hot_table)
    moved = _movement(torch.cat(start + [hot0]),
                      torch.cat(got_rows + [hot]),
                      torch.cat(want_rows + [st.hot_table]))
    ok &= _moved_ok(moved) and _still_or_moved_ok(cold)
    dense_err = 0.0
    for k, v in fres[0]["dense"].items():
        dense_err = max(dense_err, float((v - st.dense[k].cpu()).abs().max()))
        ok &= bool(torch.allclose(v, st.dense[k].cpu(), rtol=1e-4,
                                  atol=1e-6))
    del st, one, start, hot0, hot, got_rows, want_rows
    _free()
    if loss_err > 1e-5 or not ok:
        raise AssertionError(f"the hybrid FAE steps differ from the "
                             f"one-device engine's: loss {loss_err}, rows "
                             f"{row_err}, hot {hot_err}, dense {dense_err}, "
                             f"movement {moved}, cold {cold}, hot {hot_m}")
    f0 = fsum[0]
    timed = max(f["timed_s"] for f in fsum)
    step_ms = timed / HYBRID_FAE_TIMED * 1e3
    ar_ms = f0["comm_host_s"].get("all_reduce", 0.0) / HYBRID_FAE_TIMED * 1e3
    return {"phase": "hybrid:fae", "model": "fae_wdl_criteo",
            "world_size": HYBRID_S, "batch_per_rank": BATCH,
            "global_batch": gb, "hot_shape": f0["hot_shape"],
            "hot_share": f0["hot_share"], "init_equal_one_device": True,
            "hot_block_identical_on_ranks": True,
            "losses": got_l.tolist(), "overflow": 0,
            "one_device": {"steps": HYBRID_STEPS,
                           "touched_cold_rows": sum(len(f["mine"])
                                                    for f in fres),
                           "loss_max_rel_err": loss_err,
                           "cold_row_max_err": row_err,
                           "hot_block_max_err": hot_err,
                           "movement": moved, "cold_movement": cold,
                           "hot_movement": hot_m,
                           "dense_max_err": dense_err},
            "plain_kernels": [f["plain_kernels"] for f in fsum],
            "launches": f0["launches"],
            "train_examples_per_s": HYBRID_FAE_TIMED * gb / timed,
            "step_ms": step_ms,
            "comm_host_s_timed": [f["comm_host_s"] for f in fsum],
            "all_reduce_host_ms": ar_ms,
            "all_reduce_share": ar_ms / step_ms,
            "step_profile": f0["step_profile"],
            "kernel_sites": f0["sites"], "evaluate": f0["evaluate"],
            "peak_mem_gb": [f["peak_mem_gb"] for f in fsum]}


def _hybrid_scheduled_gates(res, saved) -> dict:
    """The scheduled leg: every chunk's arrays the same on both ranks; a
    flush and a pull in at least one gated step; the gated steps'
    launches those of their phases; overflow 0 and no deferred flush;
    the hot block and the tower bit-identical on both ranks after the
    gated steps and at the end; the plain versions' run of the gated chunk
    within train's gates (losses 1e-5 relative, the flushed table rows,
    the hot block and the cache's value plane within one bf16 ulp, the
    delta plane within 1e-5 of its largest value, dense 1e-5, the
    movement of the flushed rows and the hot block within 1%); the stream
    drained and sync_cache moving some of the rows it flushed and writing
    the hot block back; a finite evaluation."""
    sums = [r["scheduled"]["summary"] for r in res]
    s0 = sums[0]
    if any(s["digests"] != s0["digests"] for s in sums):
        raise AssertionError("the ranks popped different chunks")
    flushes = sum(v[0] for v in s0["variants"])
    pulls = sum(v[2] for v in s0["variants"])
    if not flushes or not pulls:
        raise AssertionError(f"the gated steps flushed in {flushes} and "
                             f"pulled in {pulls} steps")
    for r, s in enumerate(sums):
        p = s["plain_kernels"]
        if s["launches"] != s["expected_launches"] or s["overflow"] \
                or s["cache"]["deferred_flush"] or not s["drained"] \
                or not s["init_hot_is_table_rows"] \
                or not s["hot_written_back"] or not s["sync_rows_moved"] \
                or not (np.isfinite(s["evaluate"]["auc"])
                        and np.isfinite(s["evaluate"]["acc"])):
            brief = {k: v for k, v in s.items()
                     if k not in ("digests", "sites", "step_profile")}
            raise AssertionError(f"scheduled rank {r}: {brief}")
        if p["loss_max_rel_err"] > 1e-5 or not p["rows_within_one_ulp"] \
                or not p["hot_within_one_ulp"] \
                or not p["value_plane_within_one_ulp"] \
                or p["delta_plane_max_err"] > 1e-5 * p["delta_plane_scale"] \
                or p["dense_max_err"] > 1e-5 or not _moved_ok(p["movement"]):
            raise AssertionError(f"scheduled rank {r}'s steps differ from "
                                 f"the plain versions of K1, K3 and K4: {p}")
    for when, blocks in saved.items():
        a = blocks[0]
        for b in blocks[1:]:
            if not torch.equal(a["hot"], b["hot"]) or any(
                    not torch.equal(a["dense"][k], b["dense"][k])
                    for k in a["dense"]):
                raise AssertionError(f"the ranks' hot blocks or towers "
                                     f"differ {when}")
    if any(s["losses"] != s0["losses"] for s in sums):
        raise AssertionError("the ranks' scheduled losses differ")
    gb = HYBRID_S * BATCH
    step_ms = max(s["timed_s"] for s in sums) / HYBRID_SCHED_TIMED * 1e3
    coll = {k: v / HYBRID_SCHED_TIMED * 1e3
            for k, v in s0["comm_host_s"].items()}
    return {"phase": "hybrid:scheduled", "model": "wdl_criteo",
            "world_size": HYBRID_S, "batch_per_rank": BATCH,
            "global_batch": gb, "pinned_rows": PINNED,
            **{k: s0[k] for k in ("cache_rows", "U_cap", "F_cap",
                                  "flush_capacity", "pull_capacity")},
            "programs_identical_on_ranks": True,
            "hot_block_and_tower_identical_on_ranks": True,
            "gated_steps": HYBRID_STEPS, "steps_with_flush": int(flushes),
            "steps_with_pull": int(pulls), "losses": s0["losses"],
            "overflow": 0, "plain_kernels": [s["plain_kernels"]
                                             for s in sums],
            "launches": s0["launches"],
            "train_examples_per_s": gb / step_ms * 1e3, "step_ms": step_ms,
            "collective_host_ms_a_step": coll,
            "collective_share": sum(coll.values()) / step_ms,
            "comm_host_s_timed": [s["comm_host_s"] for s in sums],
            "step_profile": s0["step_profile"],
            "kernel_sites": s0["sites"], "cache": s0["cache"],
            "sync_rows": [s["sync_rows"] for s in sums],
            "sync_rows_moved": [s["sync_rows_moved"] for s in sums],
            "evaluate": s0["evaluate"],
            "peak_mem_gb": [s["peak_mem_gb"] for s in sums]}


def phase_launch_hybrid() -> dict:
    """`torch.distributed.run --standalone` in subprocesses, at full width:
    2 ranks on card 0 (`--device cuda:0`, so gloo) for 16 steps, then
    `--model fae_wdl_criteo` (one epoch: the FAE branch takes no
    --max-steps), `--assign-only` (16 steps), and `--scheduled` and
    `--scheduled --int8-flush` (one epoch each, so that the cache syncs
    and the last eval is exact) the same way, these four at once (their
    rates share the card, as the emitted line's `measures` says); then 1
    rank
    (its own card, so NCCL) and the local launcher over the same data for
    8 steps, whose per-step losses must be equal; then the stop/resume
    pairs, the resize and the supervisor of `_resume_pairs`."""
    common = ["herald_tpu_torch.launch", "--model", "wdl_criteo",
              "--bf16-table", "--rows", str(FULL_ROWS), "--samples", "16384",
              "--scan-steps", "8"]
    run = ["torch.distributed.run", "--standalone", "--nproc-per-node"]
    two_ranks = run + ["2", "-m", *common, "--comm", "hybrid", "--device",
                       "cuda:0"]
    t0 = time.perf_counter()
    two = _report(_run(two_ranks + ["--max-steps", "16"]))
    two_s = time.perf_counter() - t0
    if (two["devices"], two["backend"], two["steps"]) != (2, "gloo", 16) \
            or not np.isfinite(two["train_loss_last"]) \
            or two["overflow_rows"] != 0 or not 0.0 <= two["val_auc"] <= 1.0:
        raise AssertionError(f"2-rank hybrid launch report: {two}")
    epoch = (16384 - int(16384 * 0.1)) // (2 * BATCH)
    want_modes = {
        "fae": (["--model", "fae_wdl_criteo"], ("fae", epoch)),
        "assigned": (["--assign-only", "--max-steps", "16"],
                     ("assigned", 16)),
        "scheduled": (["--scheduled"], ("scheduled", epoch)),
        "scheduled_int8": (["--scheduled", "--int8-flush"],
                           ("scheduled", epoch))}
    # the four launches at once, each on a thread: their start-ups, not
    # their steps, take the time
    got = _on_threads({mode: (lambda argv=argv: _timed_run(two_ranks + argv))
                       for mode, (argv, _) in want_modes.items()})
    modes = {mode: rep for mode, (rep, _) in got.items()}
    modes_s = {mode: secs for mode, (_, secs) in got.items()}
    for mode, (_, want) in want_modes.items():
        rep = modes[mode]
        if (rep["devices"], rep["backend"], rep["mode"], rep["steps"]) != \
                (2, "gloo", *want) or not np.isfinite(rep["train_loss_last"]) \
                or not 0.0 <= rep["val_auc"] <= 1.0 \
                or rep.get("overflow_rows", 0) != 0:
            raise AssertionError(f"2-rank {mode} launch report: {rep}")
    if modes["fae"]["num_hot"] != 337_625 \
            or modes["assigned"]["sched"]["miss_pull"] <= 0 \
            or any(modes[m]["cache"]["update_push"] <= 0
                   or modes[m]["cache"]["deferred_flush"]
                   for m in ("scheduled", "scheduled_int8")):
        raise AssertionError(f"2-rank launch reports: {modes}")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        one = _report(_run(run + ["1", "-m", *common, "--comm", "hybrid",
                                  "--max-steps", "8", "--log-dir",
                                  str(tmp / "one")]))
        local = _report(_run(common + ["--max-steps", "8", "--log-dir",
                                       str(tmp / "local")]))
        la, lb = (np.load(tmp / d / "losses.npy") for d in ("one", "local"))
    if (one["devices"], one["backend"]) != (1, "nccl") \
            or not np.array_equal(la, lb) or one["val_auc"] != \
            local["val_auc"]:
        raise AssertionError(f"1-rank hybrid launch {one} against the "
                             f"local launcher {local}")
    pairs = _resume_pairs(run)
    keys = ("devices", "backend", "device", "steps", "train_loss_last",
            "val_auc", "examples_per_sec")
    out = {"phase": "launch:hybrid", "two_ranks_command_s": two_s,
           "measures": "two_ranks_fae, two_ranks_assigned, "
                       "two_ranks_scheduled and two_ranks_scheduled_int8 "
                       "ran at once, sharing card 0: their "
                       "examples_per_sec, examples_per_sec_steady and "
                       "command_s are not one launch's alone",
           "two_ranks": {k: two[k] for k in keys},
           "two_ranks_fae": {**{k: modes["fae"][k] for k in keys},
                             "num_hot": modes["fae"]["num_hot"],
                             "command_s": modes_s["fae"]},
           "two_ranks_assigned": {**{k: modes["assigned"][k] for k in keys},
                                  "sched": modes["assigned"]["sched"],
                                  "command_s": modes_s["assigned"]},
           **{f"two_ranks_{m}": {**{k: modes[m][k] for k in keys},
                                 "cache": modes[m]["cache"],
                                 "examples_per_sec_steady":
                                     modes[m]["examples_per_sec_steady"],
                                 "command_s": modes_s[m]}
              for m in ("scheduled", "scheduled_int8")},
           "one_rank": {k: one[k] for k in ("devices", "backend", "steps",
                                            "val_auc")},
           "one_rank_losses_equal_local": True, **pairs}
    emit(out)
    return out


RESUME_ROWS, RESUME_STOP = 65_536, 8


def _timed_run(argv):
    """(report, command seconds) of a launch."""
    t0 = time.perf_counter()
    rep = _report(_run(argv))
    return rep, time.perf_counter() - t0


def _on_threads(jobs: dict) -> dict:
    """Each job (a function) on a thread of its own, all at once: their
    results, or the first job's error."""
    results, errors = {}, []

    def go(name, fn):
        try:
            results[name] = fn()
        except BaseException as e:        # re-raised below
            errors.append(e)
    threads = [threading.Thread(target=go, args=job) for job in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def _resume_pairs(run) -> dict:
    """launch:hybrid's checkpoints, at RESUME_ROWS rows (batch 256 a rank,
    bf16): for the plain, assign-only and scheduled branches with 2 ranks
    on card 0, an epoch of 28 steps against the same run stopped by
    --max-steps RESUME_STOP with --ckpt and resumed with --resume: the
    steps add up, and val_auc, the last epoch's val_auc and the last 20
    steps' mean loss (all 20 the resumed run's) are the uninterrupted
    run's. 1 rank (NCCL) resumes the 2-rank plain checkpoint (a resize)
    and trains to a finite loss; and the supervisor runs a 1-rank
    scheduled child that crashes at step 6 (checkpoints every 4) to the
    uninterrupted run's report (tests/test_supervise.py's gates). Every
    launch that needs no other's checkpoint starts at once, each on a
    thread of its own: the process start-ups, not the steps, take the
    time."""
    small = ["herald_tpu_torch.launch", "--model", "wdl_criteo",
             "--bf16-table", "--rows", str(RESUME_ROWS), "--samples",
             "16384", "--scan-steps", "4"]
    two = run + ["2", "-m", *small, "--comm", "hybrid", "--device",
                 "cuda:0"]
    # a cache of a quarter of the rows: 10% would hold fewer than one
    # batch's 6,656 ids
    sched = ["--scheduled", "--cache-limit-ratio", "0.25"]
    modes = {"plain": [], "assigned": ["--assign-only"], "scheduled": sched}
    child = [*small[1:], *sched, "--scan-steps", "2"]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        stopped = threading.Event()     # the plain 2-rank checkpoint exists

        def ck(mode):
            return str(tmp / f"ck-{mode}")

        def stop_and_resume(mode):
            try:
                stop = _timed_run(two + modes[mode] + [
                    "--max-steps", str(RESUME_STOP), "--ckpt", ck(mode)])
            finally:
                if mode == "plain":
                    stopped.set()
            return stop, _timed_run(two + modes[mode] + ["--resume",
                                                         ck(mode)])

        def resize():
            # one rank on its own card resumes the 2-rank checkpoint at
            # step 8, at its own batches of 256
            stopped.wait()
            return _timed_run(run + ["1", "-m", *small, "--comm", "hybrid",
                                     "--max-steps", "16", "--resume",
                                     ck("plain")])

        def supervised():
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "herald_tpu_torch.launch.supervise",
                 "--ckpt-dir", str(tmp / "sup"), "--ckpt-every", "4",
                 "--backoff", "0.1", "--", *child, "--crash-after", "6"],
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            return proc, time.perf_counter() - t0
        def exported(name):
            # the run's final state (its checkpoint) and rank 0's file
            return ["--ckpt", str(tmp / f"ck-export-{name}"),
                    "--export-onnx", str(tmp / f"{name}.onnx")]
        t0 = time.perf_counter()
        got = _on_threads({
            **{f"{m}-whole": (lambda m=m: _timed_run(
                two + modes[m] + (exported("plain") if m == "plain"
                                  else [])))
               for m in modes},
            **{m: (lambda m=m: stop_and_resume(m)) for m in modes},
            "resize": resize, "supervise": supervised,
            "supervise-whole": lambda: _timed_run(
                ["herald_tpu_torch.launch", *child,
                 *exported("scheduled")])})
        wall = time.perf_counter() - t0
        onnx = {"plain_two_ranks": _exported_launch(tmp, "plain"),
                "scheduled_one_rank": _exported_launch(tmp, "scheduled")}
    out = {"resume_rows": RESUME_ROWS}
    for mode in modes:
        (w, w_s), ((s, s_s), (r, r_s)) = got[f"{mode}-whole"], got[mode]
        if s["steps"] != RESUME_STOP or r["steps"] != 20 \
                or s["steps"] + r["steps"] != w["steps"] \
                or w["val_auc"] is None or r["devices"] != 2 \
                or (r["val_auc"], r["train_loss_last"],
                    r["epochs"][-1]["val_auc"]) != \
                (w["val_auc"], w["train_loss_last"],
                 w["epochs"][-1]["val_auc"]):
            raise AssertionError(f"{mode}: the resumed run {r} and {s} "
                                 f"differ from the uninterrupted {w}")
        out[f"resume_{mode}"] = {
            "steps": [w["steps"], s["steps"], r["steps"]],
            "val_auc": w["val_auc"], "train_loss_last": w["train_loss_last"],
            "resumed_equal": True, "command_s": [w_s, s_s, r_s]}
    o, o_s = got["resize"]
    if (o["devices"], o["backend"], o["steps"]) != \
            (1, "nccl", 16 - RESUME_STOP) \
            or not np.isfinite(o["train_loss_last"]):
        raise AssertionError(f"the 1-rank resume of the 2-rank "
                             f"checkpoint: {o}")
    out["resume_plain"]["resize_to_one_rank"] = {
        "steps": o["steps"], "backend": o["backend"],
        "train_loss_last": o["train_loss_last"], "val_auc": o["val_auc"],
        "command_s": o_s}
    (proc, sup_s), (ref, ref_s) = got["supervise"], got["supervise-whole"]
    rep = _report(proc.stdout) if proc.returncode == 0 else None
    if rep is None or '"crashed_at": 6' not in proc.stdout \
            or proc.stderr.count("launch (attempt") != 2 \
            or "restarting from checkpoint" not in proc.stderr \
            or rep["stopped_early"] or rep["steps"] != ref["steps"] - 4 \
            or (rep["val_auc"], rep["val_acc"]) != (ref["val_auc"],
                                                    ref["val_acc"]):
        raise AssertionError(
            f"the supervised run (rc {proc.returncode}) against {ref}:\n"
            f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    out["supervise"] = {"steps": [ref["steps"], rep["steps"]],
                        "crashed_at": 6, "resumed_from": 4,
                        "val_auc": rep["val_auc"], "report_equal": True,
                        "command_s": [ref_s, sup_s]}
    out["resume_wall_s"] = wall
    out["export_onnx"] = onnx
    return out


def _exported_launch(tmp: Path, name: str) -> dict:
    """A launch's `--export-onnx` file against its final state: the
    checkpoint it wrote at the end, loaded on this card (a 2-rank plain
    one onto one device, a cached one as its table and tower), scores
    ONNX_BATCHES batches through Engine.predict as the file does through
    OnnxModel, within ONNX_RTOL and ONNX_ATOL."""
    from herald_tpu_torch.onnx import OnnxModel
    cfg = HeraldConfig(model="wdl_criteo", batch_size=BATCH,
                       embedding_dim=EMB, table_dtype=torch.bfloat16)
    eng = Engine(cfg, table_rows=RESUME_ROWS, device=DEVICE)
    ck = str(tmp / f"ck-export-{name}")
    state = (CachedEngine.to_base_state(load_cached_checkpoint(ck, DEVICE))
             if name == "scheduled" else
             load_checkpoint(ck, DEVICE, padded_rows=eng.padded_rows))
    dense, sparse, _ = synthetic_ctr_data(eng.model.spec,
                                          ONNX_BATCHES * BATCH, seed=1,
                                          num_rows=RESUME_ROWS)
    path = tmp / f"{name}.onnx"
    om = OnnxModel.load(str(path))
    want, got = [], []
    for lo in range(0, len(sparse), BATCH):
        d, s = dense[lo:lo + BATCH], sparse[lo:lo + BATCH]
        want.append(eng.predict(state, d, s).cpu().numpy())
        got.append(om(sparse_ids=s.astype(np.int64),
                      dense_x=d.astype(np.float32))[0])
    want, got = np.concatenate(want), np.concatenate(got)
    diff = float(np.abs(got - want).max())
    if not np.allclose(got, want, rtol=ONNX_RTOL, atol=ONNX_ATOL):
        raise AssertionError(f"launch:hybrid {name}: the exported file's "
                             f"scores differ from its checkpoint's by up "
                             f"to {diff}")
    return {"file_bytes": path.stat().st_size, "scored_rows": len(got),
            "max_abs_diff": diff}


# ----------------------------------------------------------------------
# hybrid:tp, autoshard, pipeline: the tensor-parallel tower over the
# (dp, mp) grid of ranks sharing this card over gloo, the layout search
# and the pipelines (parallel/tp.py, autoshard.py, pipeline.py)
# ----------------------------------------------------------------------

TP_SIZES, TP_MP, TP_STEPS, TP_TIMED = (2, 4), 2, 8, 32
# the layout search's table: its scores count bytes and FLOPs of one
# step, which do not depend on the row count (a cut of rows)
TP_SEARCH_ROWS = 65_536
# the step's counted collective bytes, at both mp, from engines over
# this many rows (the bytes do not depend on the rows either)
TP_BYTES_ROWS = 65_536
# pipelines: stages of wdl's 256-wide tower layers, a batch of 256 a dp
# replica in PIPE_M micro-batches, over (dp, pp) = (2, 2) ranks
PIPE_STAGES, PIPE_M, PIPE_W, PIPE_LR = 2, 4, 256, 0.05
# values against the sequential tower and 1F1B against the slot-by-slot
# oracle, all f32 on this card with TF32 off: the same products over
# other row counts may sum in another order. GPipe's values are held as
# max |a - b| <= PIPE_RTOL * max |b| (two relu layers of K = 256 sums:
# an elementwise rtol fails near zero; the first run on the card gave
# 2.4e-6 against atol 1e-6 there)
PIPE_RTOL, PIPE_ATOL = 1e-5, 1e-6
PIPE_GRAD_RTOL = 1e-4


def _tp_cfg(mp: int, **kw) -> HeraldConfig:
    return HeraldConfig(model="wdl_criteo", batch_size=BATCH,
                        embedding_dim=EMB, table_dtype=torch.bfloat16,
                        comm_mode="hybrid", mp_shards=mp, **kw)


def _tp_bytes() -> dict:
    """One step's collective bytes by kind and its calls, at mp = TP_MP and
    at mp = 1 over the same ranks, from zero args (`example_step_args`)
    of engines over TP_BYTES_ROWS rows."""
    from herald_tpu_torch.utils.hlo_stats import collective_bytes
    out = {}
    for mp in (TP_MP, 1):
        eng = Engine(_tp_cfg(mp), table_rows=TP_BYTES_ROWS,
                     device=DEVICE + ":0")
        out[f"mp{mp}"] = collective_bytes(
            eng._train_step_body, eng.init_state(0),
            *eng.example_step_args(), comm=eng.comm)
        del eng
    return out


def _tp_leg(rank: int, S: int) -> dict:
    """hybrid:tp on this rank: wdl_criteo at full width over (S / TP_MP,
    TP_MP), from its own init_state(0); TP_STEPS steps through the kernels
    (launches counted), `predict` of a held-out global batch and
    `evaluate` of four, the same steps from the same state through the
    plain versions of K1 and K3, TP_TIMED timed steps, a profiled chunk on
    rank 0, and at S = 4 the K1 and K3 inputs of TP_STEPS steps recorded
    on rank 0 and timed; the collective bytes of a step at both mp."""
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    eng = Engine(_tp_cfg(TP_MP), table_rows=FULL_ROWS, device=DEVICE + ":0")
    comm = eng.comm
    gb = S * BATCH
    torch.cuda.reset_peak_memory_stats()
    state = eng.init_state(0)
    init = {"rows": state.table[:1024].clone().cpu(),
            "dense": {k: v.clone().cpu() for k, v in state.dense.items()}}
    n = 3 * TP_STEPS + TP_TIMED + 4
    dense, sparse, labels = synthetic_ctr_data(eng.model.spec, n * gb,
                                               seed=0, num_rows=FULL_ROWS)

    def batches(lo, k):
        z = slice(lo * gb, (lo + k) * gb)
        return dense[z], sparse[z], labels[z]

    touched = np.unique(sparse[:TP_STEPS * gb])
    mine = touched[touched % S == rank]
    local = torch.as_tensor(mine // S, device=comm.device)
    start = (state.table[local].clone(),
             {k: v.clone() for k, v in state.dense.items()})
    for kern in KERNELS.values():
        kern.launches = 0
    state, st = eng.train_epoch(state, *batches(0, TP_STEPS))
    launches = _launch_counts()
    losses, overflow = st["loss"].cpu(), st["overflow"].cpu()
    rows = state.table[local].clone()
    dense_after = {k: v.clone() for k, v in state.dense.items()}
    held = batches(TP_STEPS, 4)
    probs = eng.predict(state, held[0][:gb], held[1][:gb]).cpu()
    ev = eng.evaluate(state, *held)
    # the same steps from the same state through the plain versions
    state.table[local] = start[0]
    for k, v in start[1].items():
        state.dense[k].copy_(v)
    state.step.zero_()
    with _patched(_hybrid_hooks({"embedding_gather": embedding_gather_ref,
                                 "hot_onehot_push": _host_k3})):
        state, st = eng.train_epoch(state, *batches(0, TP_STEPS))
    p_losses, p_rows = st["loss"].cpu(), state.table[local]
    plain = {
        **_movement(start[0], rows, p_rows),
        "loss_max_rel_err": float(((losses - p_losses).abs()
                                   / p_losses.abs()).max()),
        "rows_within_one_ulp": bool(torch.allclose(
            rows.float(), p_rows.float(), rtol=2 ** -7, atol=0)),
        "dense_max_err": max(float((dense_after[k] - state.dense[k]).abs()
                                   .max()) for k in state.dense)}
    del start
    # timed steps, every rank from one barrier
    lo = TP_STEPS + 4
    dist.barrier()
    torch.cuda.synchronize()
    sec0 = dict(comm.seconds)
    t0 = time.perf_counter()
    state, st = eng.train_epoch(state, *batches(lo, TP_TIMED))
    float(st["loss"][-1])
    timed_s = time.perf_counter() - t0
    comm_s = {k: v - sec0.get(k, 0.0) for k, v in comm.seconds.items()}
    holder = [state]
    prof_batches = batches(lo + TP_TIMED, TP_STEPS)

    def chunk(_i):
        holder[0], _ = eng.train_epoch(holder[0], *prof_batches)

    profile = None
    sec0 = dict(comm.seconds)
    if rank == 0:
        prof, host_ms, lost = _session(chunk, 1)
        per, _ = _device_items(prof, TP_STEPS)
        host_ms /= TP_STEPS
        busy = None if lost else sum(per.values())
        coll = {k: (comm.seconds[k] - sec0.get(k, 0.0)) * 1e3 / TP_STEPS
                for k in comm.seconds}
        profile = {"steps": TP_STEPS, "device_busy_ms": busy,
                   "host_ms_profiled": host_ms,
                   "device_idle_share": None if busy is None
                   else 1 - busy / host_ms,
                   "embedding_gather_device_ms": _own_ms(per, K1),
                   "hot_onehot_push_device_ms": _k3_ms(per),
                   "collective_host_ms": coll,
                   "collective_share": sum(coll.values()) / host_ms,
                   "top_device_ms": _top(per), "lost_launches": len(lost)}
    else:
        chunk(0)
        torch.cuda.synchronize()
    state = holder[0]
    sites = None
    if S == 4:
        calls = []
        with _patched(_recording(calls) if rank == 0 else {}):
            state, _ = eng.train_epoch(state, *batches(0, TP_STEPS))
        if rank == 0:
            per_step = len(HYBRID_SITES)
            if len(calls) != per_step * TP_STEPS or any(
                    calls[i][0] != HYBRID_SITES[i % per_step][0]
                    for i in range(len(calls))):
                raise AssertionError(
                    f"the TP step called {[c[0] for c in calls[:8]]}")
            sites = {f"{kern}:{site}": _hybrid_site_timing(kern, [
                calls[i][1] for i in range(j, len(calls), per_step)])
                for j, (kern, site) in enumerate(HYBRID_SITES)}
        dist.barrier()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    shapes = {"table": list(state.table.shape),
              "dense": {k: list(v.shape) for k, v in state.dense.items()}}
    del state, eng, holder
    _free()
    return {"rank": rank, "backend": comm.backend, "world_size": comm.size,
            "init": init, "mine": mine, "rows": rows.cpu(),
            "losses": losses, "overflow": overflow,
            "dense": {k: v.cpu() for k, v in dense_after.items()},
            "probs": probs, "eval": ev, "launches": launches,
            "plain_kernels": plain, "timed_s": timed_s,
            "comm_host_s": comm_s, "step_profile": profile, "sites": sites,
            "bytes": _tp_bytes(), "shapes": shapes, "peak_mem_gb": peak_gb}


def _autoshard_leg(rank: int) -> dict:
    """autoshard on this rank: `search_layout("wdl_criteo")` over the
    ranks (batch 256, embedding 128, TP_SEARCH_ROWS rows), then 2 steps of
    the chosen layout."""
    from herald_tpu_torch.parallel.autoshard import (format_table,
                                                     search_layout)
    t0 = time.perf_counter()
    cfg, scores = search_layout("wdl_criteo", batch_size=BATCH,
                                embedding_dim=EMB, table_rows=TP_SEARCH_ROWS,
                                device=DEVICE + ":0")
    search_s = time.perf_counter() - t0
    eng = Engine(dataclasses.replace(cfg, table_dtype=torch.bfloat16),
                 table_rows=TP_SEARCH_ROWS, device=DEVICE + ":0")
    d, s, y = synthetic_ctr_data(eng.model.spec,
                                 2 * eng.num_shards * BATCH, seed=2,
                                 num_rows=TP_SEARCH_ROWS)
    _, st = eng.train_epoch(eng.init_state(0), d, s, y, steps=2)
    del eng
    _free()
    return {"table": format_table(cfg, scores), "mp_shards": cfg.mp_shards,
            "scores": [dataclasses.asdict(s) for s in scores],
            "search_s": search_s,
            "chosen_losses": st["loss"].tolist()}


def _pipe_oracle(W, b, x, targets, M, lr):
    """The 1F1B timetable run slot by slot on one device, with each
    micro-batch's update applied at its backward (tests/test_pipeline.py's
    `_pipedream_oracle`): x and targets hold the combined batch, laid out
    [M, DP, mb] so that micro-batch m is every replica's m-th."""
    N = W.shape[0]
    xs, tg = x.reshape(M, -1, x.shape[-1]), targets.reshape(M, -1,
                                                          x.shape[-1])
    params = [{"W": W[s].clone(), "b": b[s].clone()} for s in range(N)]
    stash = [dict() for _ in range(N)]
    fmsg, bmsg, losses = {}, {}, torch.zeros(M, device=x.device)
    for t in range(2 * (M + N - 1)):
        for s in range(N):
            rf = t - s
            if rf >= 0 and rf % 2 == 0 and rf // 2 < M:
                m = rf // 2
                x_in = xs[m] if s == 0 else fmsg.pop((s, m))
                w = dict(params[s])
                stash[s][m] = (w, x_in)
                if s + 1 < N:
                    fmsg[(s + 1, m)] = _pipe_stage(w, x_in).detach()
            rb = t - (2 * N - 1 - s)
            if rb >= 0 and rb % 2 == 0 and rb // 2 < M:
                m = rb // 2
                w, x_in = stash[s].pop(m)
                wg = {k: v.detach().requires_grad_(True) for k, v in w.items()}
                xg = x_in.detach().requires_grad_(True)
                with torch.enable_grad():
                    y = _pipe_stage(wg, xg)
                    if s == N - 1:
                        loss = torch.mean((y - tg[m]) ** 2)
                        losses[m] = loss.detach()
                        g = torch.autograd.grad(loss, y, retain_graph=True)[0]
                    else:
                        g = bmsg.pop((s, m))
                    gw = torch.autograd.grad(y, [wg["W"], wg["b"], xg], g)
                params[s] = {"W": params[s]["W"] - lr * gw[0],
                             "b": params[s]["b"] - lr * gw[1]}
                if s > 0:
                    bmsg[(s - 1, m)] = gw[2]
    return params, losses


def _pipe_stage(params, h):
    return torch.relu(h @ params["W"] + params["b"])


def _pipeline_leg(rank: int, world) -> dict:
    """pipeline on this rank of (dp, pp) = (2, 2): GPipe's values and
    grads against the sequential tower on this card, 1F1B (the update's
    grads summed over dp) and HetPipe (local updates, averaged over dp
    after each, and after every second) against the slot-by-slot oracle
    of the combined batch; the host ms of each."""
    from herald_tpu_torch.parallel import pipeline as pl
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = world.device
    pp = world.split([[0, 1], [2, 3]])
    dp = world.split([[0, 2], [1, 3]])
    N, M, DP = PIPE_STAGES, PIPE_M, 2
    gen = torch.Generator(device=dev).manual_seed(0)
    W = 0.1 * torch.randn((N, PIPE_W, PIPE_W), generator=gen, device=dev)
    b = 0.1 * torch.randn((N, PIPE_W), generator=gen, device=dev)
    x = torch.randn((DP * BATCH, PIPE_W), generator=gen, device=dev)
    tgt = torch.randn((DP * BATCH, PIPE_W), generator=gen, device=dev)
    i = dp.rank
    mine = slice(i * BATCH, (i + 1) * BATCH)
    my = {"W": W[pp.rank].clone().requires_grad_(True),
          "b": b[pp.rank].clone().requires_grad_(True)}
    out, times = {}, {}

    def seq(ws, bs, h):
        for s in range(N):
            h = _pipe_stage({"W": ws[s], "b": bs[s]}, h)
        return h
    # GPipe: values and grads against the sequential tower
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.enable_grad():
        y = pl.pipeline_apply(_pipe_stage, my, x[mine], pp, N, M)
        loss = pl.stage_loss(lambda yy: torch.mean((yy - tgt[mine]) ** 2)
                             / DP, y, pp, N)
        g = torch.autograd.grad(loss, [my["W"], my["b"]])
    g = [dp.all_reduce_(v.contiguous()) for v in g]
    value = pl.last_stage_value(y.detach(), pp, N)
    loss_all = world.all_reduce_(loss.detach().reshape(1))
    torch.cuda.synchronize()
    times["gpipe_ms"] = (time.perf_counter() - t0) * 1e3
    Wr, br = W.clone().requires_grad_(True), b.clone().requires_grad_(True)
    with torch.enable_grad():
        ref = seq(Wr, br, x)
        lref = torch.mean((ref - tgt) ** 2)
        gW, gb_ = torch.autograd.grad(lref, [Wr, br])

    def err(a, r):
        return float((a - r).abs().max())
    out["gpipe"] = {
        "value_max_err": err(value, ref[mine].detach()),
        "value_ok": err(value, ref[mine].detach())
        <= PIPE_RTOL * float(ref[mine].abs().max()),
        "loss_rel_err": float(abs(loss_all - lref.detach()) / lref.detach()),
        "grad_max_err": max(err(g[0], gW[pp.rank]), err(g[1], gb_[pp.rank])),
        "grads_ok": bool(torch.allclose(g[0], gW[pp.rank],
                                        rtol=PIPE_GRAD_RTOL, atol=PIPE_ATOL)
                         and torch.allclose(g[1], gb_[pp.rank],
                                            rtol=PIPE_GRAD_RTOL,
                                            atol=PIPE_ATOL))}
    # 1F1B and HetPipe against the oracle of the combined batch: replica
    # i's micro-batch m is the oracle's rows [m, i]
    mb = BATCH // M
    comb = lambda a: a.reshape(DP, M, mb, PIPE_W).transpose(0, 1).reshape(
        -1, PIPE_W)
    want_p, want_l = _pipe_oracle(W, b, comb(x), comb(tgt), M, PIPE_LR)
    start = {"W": W[pp.rank], "b": b[pp.rank]}

    def lockstep(p, gr):
        return {k: p[k] - PIPE_LR * dp.all_reduce_(gr[k].contiguous()) / DP
                for k in p}

    def local(p, gr):
        return {k: p[k] - PIPE_LR * gr[k] for k in p}
    runs = {}
    for name, kw in (("1f1b", {"update_fn": lockstep}),
                     ("hetpipe", {"update_fn": local, "dp_comm": dp,
                                  "dp_sync_every": 1}),
                     ("hetpipe_k2", {"update_fn": local, "dp_comm": dp,
                                     "dp_sync_every": 2})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, losses = pl.pipedream_apply(_pipe_stage,
                                       lambda yy, tt: torch.mean(
                                           (yy - tt) ** 2),
                                       start, x[mine], tgt[mine], pp, N, M,
                                       **kw)
        losses = dp.all_reduce_(pp.all_reduce_(losses.clone())) / DP
        torch.cuda.synchronize()
        times[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
        runs[name] = (p, losses)
        wp = want_p[pp.rank]
        out[name] = {
            "loss_max_err": err(losses, want_l),
            "param_max_err": max(err(p[k], wp[k]) for k in p),
            "ok": bool(torch.allclose(losses, want_l, rtol=PIPE_RTOL,
                                      atol=PIPE_ATOL) and all(
                torch.allclose(p[k], wp[k], rtol=PIPE_RTOL, atol=PIPE_ATOL)
                for k in p))}
    stale = runs["hetpipe_k2"]
    out["hetpipe_k2"] = {
        "differs": max(err(stale[0][k], runs["1f1b"][0][k])
                       for k in stale[0]) > 1e-7,
        "losses_finite": bool(torch.isfinite(stale[1]).all())}
    return {"checks": out, "host_ms": times, "stage": pp.rank,
            "replica": dp.rank}


def tp_rank(rank: int, size: int, tmp: Path) -> None:
    """One rank of the tp phase, in a process of its own on the card
    (`--tp-rank R --tp-size S --tp-dir DIR`): hybrid:tp at S ranks, and at
    S = 4 also autoshard and pipeline. Writes tp<R>.pt to DIR."""
    import torch.distributed as dist
    from herald_tpu_torch.parallel.comm import setup
    world = setup(DEVICE + ":0", init_method=f"file://{tmp}/store",
                  rank=rank, world_size=size)
    res = {"tp": _tp_leg(rank, size)}
    if size == 4:
        res["autoshard"] = _autoshard_leg(rank)
        res["pipeline"] = _pipeline_leg(rank, world)
    torch.save(res, tmp / f"tp{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _spawn_tp(size: int, timeout: float = 600) -> tuple:
    """(results of the `size` tp ranks, seconds) on this card."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        logs = [open(tmp / f"tp{r}.log", "w") for r in range(size)]
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--tp-rank",
             str(r), "--tp-size", str(size), "--tp-dir", str(tmp)],
            cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(size)]
        try:
            for p in procs:
                p.wait(timeout=max(1.0, timeout - (time.perf_counter()
                                                   - t0)))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        secs = time.perf_counter() - t0
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise AssertionError(
                    f"tp rank {r} of {size} exited {p.returncode}:\n"
                    f"{(tmp / f'tp{r}.log').read_text()[-4000:]}")
        return [torch.load(tmp / f"tp{r}.pt", weights_only=False)
                for r in range(size)], secs


def _tp_gates(res: list, S: int) -> dict:
    """hybrid:tp at S ranks against the one-device engine (batch 256 * S)
    from the same logical state over the same global batches: each rank's
    init rows and tower shards equal its part of the one-device
    init_state(0); losses within rtol 1e-5, overflow 0, touched rows within
    2^-7 of their value plus 2^-13 and moved as the reference's (within
    1%), the tower (joined from the shards) within rtol 1e-4, atol 1e-6;
    the held-out predictions within 1e-4 and the AUC within 1e-3; each
    rank's steps against the plain versions of K1 and K3 as hybrid's
    gates, and HYBRID_STEP's launches a step."""
    from herald_tpu_torch.parallel import tp
    summ = [r["tp"] for r in res]
    want_launches = _want(HYBRID_STEP, TP_STEPS)
    for s in summ:
        if s["backend"] != "gloo" or s["world_size"] != S \
                or s["launches"] != want_launches:
            raise AssertionError(f"hybrid:tp rank {s['rank']} of {S}: "
                                 f"{s['backend']}, launches "
                                 f"{s['launches']} (want {want_launches})")
        p = s["plain_kernels"]
        if p["loss_max_rel_err"] > 1e-5 or not p["rows_within_one_ulp"] \
                or p["dense_max_err"] > 1e-5 or not _moved_ok(p):
            raise AssertionError(f"hybrid:tp rank {s['rank']} of {S} "
                                 f"differs from the plain versions: {p}")
    if any(not torch.equal(s["losses"], summ[0]["losses"]) for s in summ) \
            or any(int(s["overflow"].sum()) for s in summ):
        raise AssertionError("hybrid:tp: the ranks' losses differ or "
                             "overflowed")
    gb = S * BATCH
    one = Engine(HeraldConfig(model="wdl_criteo", batch_size=gb,
                              embedding_dim=EMB, table_dtype=torch.bfloat16),
                 table_rows=FULL_ROWS, device=DEVICE)
    st = one.init_state(0)
    plan = one.model.tp_plan
    for s in summ:
        r = s["rank"]
        cut = tp.cut({k: v.cpu() for k, v in st.dense.items()}, plan, TP_MP,
                     r % TP_MP)
        if not torch.equal(s["init"]["rows"],
                           st.table[r::S][:1024].cpu()) or any(
                not torch.equal(s["init"]["dense"][k], cut[k]) for k in cut):
            raise AssertionError(f"hybrid:tp rank {r} of {S}: init_state(0) "
                                 f"is not its part of the one-device one")
    n = 3 * TP_STEPS + TP_TIMED + 4
    dense, sparse, labels = synthetic_ctr_data(one.model.spec, n * gb,
                                               seed=0, num_rows=FULL_ROWS)
    mine = [torch.as_tensor(s["mine"], device=DEVICE) for s in summ]
    start = [st.table[m].clone() for m in mine]
    z = slice(0, TP_STEPS * gb)
    st, stats = one.train_epoch(st, dense[z], sparse[z], labels[z])
    want_l = stats["loss"].cpu()
    loss_err = float(((summ[0]["losses"] - want_l).abs()
                      / want_l.abs()).max())
    row_err, ok, moves = 0.0, True, []
    for s, m, s0 in zip(summ, mine, start):
        a, w = s["rows"].to(DEVICE), st.table[m]
        row_err = max(row_err, float((a.float() - w.float()).abs().max()))
        ok &= bool(torch.allclose(a.float(), w.float(), rtol=2 ** -7,
                                  atol=2 ** -13))
        moves.append(_movement(s0, a, w))
        ok &= _moved_ok(moves[-1])
    joined = tp.join([{k: v.numpy() for k, v in s["dense"].items()}
                      for s in summ[:TP_MP]], plan)
    dense_err = max(float(np.abs(joined[k] - st.dense[k].cpu().numpy())
                          .max()) for k in joined)
    ok &= all(np.allclose(joined[k], st.dense[k].cpu().numpy(), rtol=1e-4,
                          atol=1e-6) for k in joined)
    held = slice(TP_STEPS * gb, (TP_STEPS + 4) * gb)
    probs = one.predict(st, dense[held][:gb], sparse[held][:gb]).cpu()
    ev = one.evaluate(st, dense[held], sparse[held], labels[held])
    prob_err = float((summ[0]["probs"] - probs).abs().max())
    auc_err = abs(summ[0]["eval"]["auc"] - ev["auc"])
    ok &= prob_err <= 1e-4 and auc_err <= 1e-3
    del st, one, start
    _free()
    if loss_err > 1e-5 or not ok:
        raise AssertionError(
            f"hybrid:tp at {S} ranks differs from the one-device engine: "
            f"loss {loss_err}, rows {row_err}, dense {dense_err}, "
            f"probabilities {prob_err}, auc {auc_err}, movement {moves}")
    by = summ[0]["bytes"]
    if by[f"mp{TP_MP}"]["all-to-all"] != by["mp1"]["all-to-all"]:
        raise AssertionError(f"hybrid:tp changed the exchange's bytes: {by}")
    timed = max(s["timed_s"] for s in summ)
    return {"phase": f"hybrid:tp:{S}", "model": "wdl_criteo",
            "backend": "gloo", "world_size": S,
            "layout": {"dp": S // TP_MP, "mp": TP_MP},
            "measures": "gloo between processes on one card, not NVLink",
            "batch_per_rank": BATCH, "global_batch": gb,
            "shapes_per_rank": summ[0]["shapes"],
            "init_equal_one_device": True, "losses": want_l.tolist(),
            "overflow": 0,
            "one_device": {"steps": TP_STEPS, "loss_max_rel_err": loss_err,
                           "row_max_err": row_err, "row_movement": moves,
                           "dense_max_err": dense_err,
                           "predict_max_abs_err": prob_err,
                           "auc": summ[0]["eval"]["auc"],
                           "auc_one_device": ev["auc"],
                           "acc": summ[0]["eval"]["acc"]},
            "plain_kernels": [s["plain_kernels"] for s in summ],
            "launches": summ[0]["launches"],
            "bytes_a_step": by,
            "train_examples_per_s": TP_TIMED * gb / timed,
            "step_ms": timed / TP_TIMED * 1e3,
            "comm_host_s_timed": [s["comm_host_s"] for s in summ],
            "step_profile": summ[0]["step_profile"],
            "kernel_sites": summ[0]["sites"],
            "peak_mem_gb": [s["peak_mem_gb"] for s in summ]}


def phase_tp() -> dict:
    """hybrid:tp at S = 2 ((dp, mp) = (1, 2)) and S = 4 ((2, 2)): ranks
    sharing this card over gloo, each a process of its own (`tp_rank`),
    held here by `_tp_gates`; the S = 4 ranks then run autoshard (the
    audit table printed, the chosen layout's 2 steps finite) and pipeline
    (GPipe, 1F1B and HetPipe against their oracles within PIPE_RTOL,
    PIPE_ATOL, GPipe's grads within PIPE_GRAD_RTOL), each emitted as a
    line of its own."""
    _free()
    out = {}
    for S in TP_SIZES:
        res, secs = _spawn_tp(S)
        line = _tp_gates(res, S)
        line["ranks_command_s"] = secs
        emit(line)
        out[S] = line
    a = [r["autoshard"] for r in res]
    if any(x["table"] != a[0]["table"] for x in a) or not all(
            np.isfinite(x["chosen_losses"]).all() for x in a):
        raise AssertionError(f"autoshard: {a}")
    valid = [s for s in a[0]["scores"] if s["valid"]]
    if {s["mp_shards"] for s in valid} != {1, 2, 4} \
            or len({s["a2a_bytes"] for s in valid}) != 1:
        raise AssertionError(f"autoshard's table: {a[0]['scores']}")
    print(a[0]["table"], flush=True)
    emit({"phase": "autoshard", "model": "wdl_criteo", "world_size": 4,
          "table_rows": TP_SEARCH_ROWS, "reduced": {"table_rows": [
              FULL_ROWS, TP_SEARCH_ROWS]},
          "link_gbps": 450.0, "peak_tflops": 67.0,
          "scores": a[0]["scores"], "chosen_mp_shards": a[0]["mp_shards"],
          "chosen_losses": a[0]["chosen_losses"],
          "search_s": max(x["search_s"] for x in a)})
    pipe = [r["pipeline"] for r in res]
    for p in pipe:
        c = p["checks"]
        if not (c["gpipe"]["value_ok"] and c["gpipe"]["grads_ok"]
                and c["gpipe"]["loss_rel_err"] <= PIPE_RTOL
                and c["1f1b"]["ok"] and c["hetpipe"]["ok"]
                and c["hetpipe_k2"]["differs"]
                and c["hetpipe_k2"]["losses_finite"]):
            raise AssertionError(f"pipeline on rank {p}: {c}")
    emit({"phase": "pipeline", "layout": {"dp": 2, "pp": PIPE_STAGES},
          "stages": PIPE_STAGES, "width": PIPE_W,
          "batch_per_replica": BATCH, "microbatches": PIPE_M,
          "lr": PIPE_LR, "rtol": PIPE_RTOL, "atol": PIPE_ATOL,
          "grad_rtol": PIPE_GRAD_RTOL,
          "measures": "gloo between processes on one card, not NVLink",
          "ranks": [{"stage": p["stage"], "replica": p["replica"],
                     **p["checks"], "host_ms": p["host_ms"]}
                    for p in pipe]})
    return out


def phase_launch_tp() -> dict:
    """`torch.distributed.run` with 2 ranks on card 0 at full width: the
    plain hybrid branch with `--mp-shards 2` for 16 steps and `--ckpt`,
    then, at once, a resume of that checkpoint onto `--mp-shards 1` at the
    same S for 8 more and, at RESUME_ROWS rows, an uninterrupted
    `--mp-shards 2` run with `--ckpt` and `--export-onnx`, the file
    scored against its checkpoint's `predict` (`_exported_launch`). The
    two share the card: their rates are not the launcher's alone."""
    run = ["torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "herald_tpu_torch.launch", "--model", "wdl_criteo",
           "--bf16-table", "--samples", "16384", "--scan-steps", "8",
           "--comm", "hybrid", "--device", "cuda:0"]
    full = run + ["--rows", str(FULL_ROWS)]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        ck = str(tmp / "ck-tp")
        tp, tp_s = _timed_run(full + ["--mp-shards", str(TP_MP),
                                      "--max-steps", "16", "--ckpt", ck])
        if (tp["devices"], tp["backend"], tp["steps"]) != (2, "gloo", 16) \
                or not np.isfinite(tp["train_loss_last"]) \
                or tp["overflow_rows"] != 0 \
                or not 0.0 <= tp["val_auc"] <= 1.0:
            raise AssertionError(f"--mp-shards launch report: {tp}")
        manifest = json.loads(
            (Path(ck) / (Path(ck) / "LATEST").read_text().strip()
             / "manifest.json").read_text())
        if manifest["layout"]["dense/W1"] != "sharded" \
                or manifest["shapes"]["dense/W1"] != [13, 256]:
            raise AssertionError(f"the TP checkpoint's tower: {manifest}")
        # the resume and the export launch at once, each on a thread
        got = _on_threads({
            "back": lambda: _timed_run(full + [
                "--mp-shards", "1", "--resume", ck, "--max-steps", "24"]),
            "export": lambda: _timed_run(run + [
                "--rows", str(RESUME_ROWS), "--mp-shards", str(TP_MP),
                "--ckpt", str(tmp / "ck-export-tp"),
                "--export-onnx", str(tmp / "tp.onnx")])})
        (back, back_s), (ex, ex_s) = got["back"], got["export"]
        if back["steps"] != 8 or not np.isfinite(back["train_loss_last"]) \
                or not 0.0 <= back["val_auc"] <= 1.0:
            raise AssertionError(f"the mp = 1 resume's report: {back}")
        onnx = _exported_launch(tmp, "tp")
    keys = ("devices", "backend", "steps", "train_loss_last", "val_auc",
            "examples_per_sec")
    out = {"phase": "launch:tp",
           "measures": "gloo between processes on one card, not NVLink",
           "tp_full_width": {**{k: tp[k] for k in keys},
                             "command_s": tp_s},
           "resumed_mp1": {**{k: back[k] for k in keys},
                           "command_s": back_s},
           "export": {**{k: ex[k] for k in keys}, "command_s": ex_s,
                      "rows": RESUME_ROWS, **onnx}}
    emit(out)
    return out


# ----------------------------------------------------------------------
# gnn: the distributed GCN (herald_tpu_torch/gnn/) at the shape of
# benchmarks/gnn_ab.py:51-70
GNN_NODES, GNN_DEGREE, GNN_CLASSES, GNN_WIDTH = 20_000, 16.0, 8, 64
GNN_CASES = ("broadcast", "pull", "halo", "halo_reorder")
GNN_S, GNN_STEPS, GNN_EPOCHS = 2, 20, 60
GNN_TIMED, GNN_PROFILED, GNN_RECORDED = 50, 10, 4
# the learning gate's feature noise: at gnn_ab's 0.6 a feature-only probe
# already scores 1.0, which no model can beat by 0.05 (the edges are the
# same draws at any noise)
GNN_LEARN_NOISE = 4.0
# kernel path against plain, 2 ranks against 1: max |a - b| over max |b|
# (f32 sums in another order); the float64 oracle: rtol = atol = 1e-4
GNN_TOL, GNN_ORACLE_TOL = 1e-5, 1e-4
GNN_GRAPH = ("src", "dst", "weight", "features", "labels", "train_mask",
             "eval_mask")


def _gnn_sites(mode: str, S: int = 1) -> list:
    """The K1 and K3 calls of one GCN step at S ranks, in order: layers 1
    and 2 forward (pull: the owner's read and the read by position; halo
    over S > 1 ranks: the send buffer; then the aggregation's read and
    sum), then layers 2 and 1 backward (the aggregation's gradient read
    and sum; pull: the send buffer and the owner's sum; halo over S > 1
    ranks: the sum of the returned gradient into the send slots). Halo at
    one rank and broadcast make no exchange through K1 or K3."""
    k1, k3 = "embedding_gather", "hot_onehot_push"
    pull, halo = mode == "pull", mode == "halo" and S > 1
    out = []
    for lay in (1, 2):
        if pull:
            out += [(k1, f"l{lay}_owner_read"), (k1, f"l{lay}_by_position")]
        if halo:
            out += [(k1, f"l{lay}_halo_send")]
        out += [(k1, f"l{lay}_read"), (k3, f"l{lay}_sum")]
    for lay in (2, 1):
        out += [(k1, f"l{lay}_grad_read"), (k3, f"l{lay}_grad_sum")]
        if pull:
            out += [(k1, f"l{lay}_send_grads"), (k3, f"l{lay}_owner_sum")]
        if halo:
            out += [(k3, f"l{lay}_halo_grad_sum")]
    return out


_GNN_HALO_SITES = ("l1_halo_send", "l2_halo_send", "l2_halo_grad_sum",
                   "l1_halo_grad_sum")


def _gnn_per_step(mode: str, S: int) -> dict:
    """Each kernel's launches in one GCN step: the calls of `_gnn_sites`."""
    return {n: sum(1 for k, _ in _gnn_sites(mode, S) if k == n)
            for n in KERNELS}


def _gnn_record(m, mode: str, S: int) -> list:
    """The K1 and K3 calls of GNN_RECORDED steps of `m`, held to
    `_gnn_sites(mode, S)`'s order: [(kernel, site, [args of each step])]."""
    calls = []
    with _patched(_recording(calls, hooks=_gnn_hooks)):
        for _ in range(GNN_RECORDED):
            m.step()
    want = _gnn_sites(mode, S)
    got = [name for name, _ in calls]
    if got != [name for name, _ in want] * GNN_RECORDED:
        raise AssertionError(f"gnn {mode}: recorded calls {got[:20]}")
    n = len(want)
    return [(name, site, [calls[i * n + j][1] for i in range(GNN_RECORDED)])
            for j, (name, site) in enumerate(want)]


def _gnn_hooks(fns: dict) -> dict:
    """{(module, name): fn} for the names through which the GCN calls K1
    and K3 (its aggregation and exchanges, and the pull's `gather_rows`)."""
    from herald_tpu_torch.gnn import gcn as gcn_mod
    from herald_tpu_torch.parallel import exchange as ex_mod
    return {(gcn_mod, "embedding_gather"): fns["embedding_gather"],
            (gcn_mod, "hot_onehot_push"): fns["hot_onehot_push"],
            (ex_mod, "embedding_gather"): fns["embedding_gather"]}


def _gnn_graph(noise: float = 0.6):
    """gnn_ab's graph: an 8-block SBM of 20,000 nodes, mean degree 16 at
    4:1 in:out, 64 features, seed 1."""
    from herald_tpu_torch.gnn import synthetic_sbm
    within = GNN_NODES / GNN_CLASSES
    return synthetic_sbm(num_nodes=GNN_NODES, num_classes=GNN_CLASSES,
                         feat_dim=GNN_WIDTH,
                         p_in=GNN_DEGREE * 0.8 / within,
                         p_out=GNN_DEGREE * 0.2 / (GNN_NODES - within),
                         noise=noise, seed=1)


def _gnn_cfg():
    from herald_tpu_torch.gnn import GCNConfig
    return GCNConfig(GNN_WIDTH, GNN_WIDTH, GNN_CLASSES)


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _gnn_run(g, mode: str, comm=None, hooks=None) -> dict:
    """A fresh GCN on the card: its first logits, GNN_STEPS SGD steps'
    losses and overflow, and its final parameters ("model": the model)."""
    from herald_tpu_torch.gnn import GCN
    with _patched(hooks or {}):
        m = GCN(_gnn_cfg(), g, comm=comm, mode=mode,
                device=DEVICE if comm is None else None)
        logits = m.logits()
        steps = [m.step() for _ in range(GNN_STEPS)]
        losses = torch.stack([loss for loss, _ in steps]).cpu().numpy()
        ovf = int(torch.stack([o for _, o in steps]).sum())
    return {"model": m, "logits": logits, "losses": losses, "overflow": ovf,
            "params": [t.detach().cpu().numpy().copy()
                       for pair in m.params for t in pair]}


def _gnn_oracle(g, params) -> np.ndarray:
    """The forward in float64 on the host: Ā (h W) + b with ReLU between
    the layers, Ā a `scipy.sparse` matrix of the graph's edges."""
    import scipy.sparse as sp
    n = g.num_nodes
    a = sp.csr_matrix((g.weight.astype(np.float64), (g.dst, g.src)),
                      shape=(n, n))
    h = g.features.astype(np.float64)
    for i, (w, b) in enumerate(params):
        h = a @ (h @ np.asarray(w, np.float64)) + np.asarray(b, np.float64)
        if i + 1 < len(params):
            h = np.maximum(h, 0.0)
    return h


_PLAIN_GNN = {"embedding_gather": embedding_gather_ref,
              "hot_onehot_push": hot_onehot_push_ref}


def _gnn_errs(a: dict, b: dict) -> dict:
    """Two `_gnn_run`s apart: first logits and final parameters, max |a -
    b| over max |b|; losses, the largest relative difference."""
    return {"logits": _rel(a["logits"], b["logits"]),
            "losses": float(np.max(np.abs(a["losses"] - b["losses"])
                                   / np.abs(b["losses"]))),
            "params": max(_rel(x, y) for x, y in zip(a["params"],
                                                     b["params"]))}


def _gnn_case(g, case: str) -> dict:
    """One case at one rank: the kernel path against the plain versions
    of K1 and K3 on the card (first logits, GNN_STEPS losses, final
    parameters, within GNN_TOL) and the first logits against the float64
    oracle. Raises on a miss."""
    from herald_tpu_torch.gnn import init_gcn_params
    mode = "halo" if case == "halo_reorder" else case
    k = _gnn_run(g, mode)
    p = _gnn_run(g, mode, hooks=_gnn_hooks(_PLAIN_GNN))
    del p["model"]
    init = [(w.numpy(), b.numpy()) for w, b in init_gcn_params(_gnn_cfg())]
    oracle = _gnn_oracle(g, init)
    err = _gnn_errs(k, p)
    oracle_err = float(np.max(np.abs(k["logits"] - oracle)
                              - GNN_ORACLE_TOL * np.abs(oracle)))
    if max(err.values()) > GNN_TOL or k["overflow"] or p["overflow"]:
        raise AssertionError(f"gnn {case}: the kernel path differs from the "
                             f"plain versions of K1 and K3 beyond {GNN_TOL}: "
                             f"{err}, overflow {k['overflow']}")
    if oracle_err > GNN_ORACLE_TOL or not np.isfinite(k["logits"]).all():
        raise AssertionError(f"gnn {case}: the first logits differ from the "
                             f"float64 scipy.sparse forward: {oracle_err}")
    return {**k, "plain_kernels": err,
            "oracle_max_abs_err": float(np.abs(k["logits"] - oracle).max())}


def _gnn_learning(g) -> dict:
    """60 epochs at one rank in halo mode on the graph's edges with
    features at GNN_LEARN_NOISE: eval accuracy beats the feature-only
    least-squares probe by 0.05 (tests/test_gnn.py:90-104)."""
    from herald_tpu_torch.gnn import GCN
    gl = _gnn_graph(GNN_LEARN_NOISE)
    if not (np.array_equal(gl.src, g.src) and np.array_equal(gl.dst, g.dst)
            and np.array_equal(gl.labels, g.labels)):
        raise AssertionError("gnn: the learning graph's edges differ")
    t0 = time.perf_counter()
    m = GCN(_gnn_cfg(), gl, mode="halo", device=DEVICE).fit(GNN_EPOCHS)
    fit_s = time.perf_counter() - t0
    acc = m.accuracy("eval")
    tr = gl.train_mask
    x = np.concatenate([gl.features, np.ones((gl.num_nodes, 1),
                                             np.float32)], 1)
    wls, *_ = np.linalg.lstsq(x[tr], np.eye(GNN_CLASSES)[gl.labels[tr]],
                              rcond=None)
    base = float(((x[~tr] @ wls).argmax(1) == gl.labels[~tr]).mean())
    if not acc > base + 0.05:
        raise AssertionError(f"gnn: eval accuracy {acc} does not beat the "
                             f"feature-only probe's {base} by 0.05")
    return {"noise": GNN_LEARN_NOISE, "epochs": GNN_EPOCHS,
            "eval_accuracy": acc, "train_accuracy": m.accuracy("train"),
            "feature_only_accuracy": base, "fit_s": fit_s}


def gnn_rank(rank: int, tmp: Path) -> None:
    """One of GNN_S ranks of the gnn phase, in a process of its own on the
    card (`--gnn-rank R --gnn-dir DIR`): each case from the graphs the
    parent saved, its first logits, GNN_STEPS steps, the collective bytes
    and the launches of one more step, and the same run with K1 and K3
    swapped for their plain versions (its differences); in halo mode, the
    inputs of the exchange's own K1 and K3 sites over GNN_RECORDED more
    steps. Writes gnn<R>.pt to DIR."""
    import torch.distributed as dist
    from herald_tpu_torch.gnn import Graph
    from herald_tpu_torch.parallel.comm import setup
    from herald_tpu_torch.utils.hlo_stats import collective_bytes
    comm = setup(DEVICE + ":0", init_method=f"file://{tmp}/store",
                 rank=rank, world_size=GNN_S)
    graphs = {}
    for name in ("graph", "graph_reorder"):
        z = np.load(tmp / f"{name}.npz")
        graphs[name] = Graph(num_nodes=int(z["num_nodes"]),
                             **{f: z[f] for f in GNN_GRAPH})
    out = {"backend": comm.backend, "world_size": comm.size}
    for case in GNN_CASES:
        reorder = case == "halo_reorder"
        g = graphs["graph_reorder" if reorder else "graph"]
        mode = "halo" if reorder else case
        r = _gnn_run(g, mode, comm)
        m = r.pop("model")
        for kern in KERNELS.values():
            kern.launches = 0
        r["bytes"] = collective_bytes(m.step, comm=comm)
        r["launches"] = _launch_counts()
        r["halo_rows"] = None if m.plan is None else m.plan.halo_rows
        p = _gnn_run(g, mode, comm, hooks=_gnn_hooks(_PLAIN_GNN))
        del p["model"]
        r["plain_kernels"] = _gnn_errs(r, p)
        r["plain_overflow"] = p["overflow"]
        if case == "halo":
            # the exchange's own K1 and K3 sites, timed by the parent
            r["halo_site_inputs"] = {
                f"{name}:halo_{GNN_S}ranks:{site}": [
                    [a.cpu() if isinstance(a, torch.Tensor) else a
                     for a in args] for args in inputs]
                for name, site, inputs in _gnn_record(m, mode, GNN_S)
                if site in _GNN_HALO_SITES}
        out[case] = r
    torch.save(out, tmp / f"gnn{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _gnn_timing(m, mode: str, timed_sites=()) -> dict:
    """One rank's step on the card: its launches (one step, no plain
    version called), host waits, host ms a step over GNN_TIMED steps,
    device busy from torch.profiler over GNN_PROFILED; and each K1 and K3
    site named in `timed_sites`, its inputs recorded over GNN_RECORDED
    steps, held against its plain version and timed
    (`_hybrid_site_timing`)."""
    for kern in KERNELS.values():
        kern.launches = 0
    with _PlainCalls() as plain:
        m.step()
        torch.cuda.synchronize()
    launches = _launch_counts()
    per_step = _gnn_per_step(mode, 1)
    if launches != per_step or plain.calls:
        raise AssertionError(f"gnn {mode}: a step launched {launches} "
                             f"(expected {per_step}), plain calls "
                             f"{plain.calls}")
    waits, wait_sites = _count_host_waits(m.step)
    for _ in range(3):
        m.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GNN_TIMED):
        m.step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / GNN_TIMED * 1e3
    busy, items, prof_host_ms, check = device_profile(lambda i: m.step(),
                                                      GNN_PROFILED)
    out = {"launches": launches, "host_waits": waits,
           "host_wait_sites": wait_sites, "step_host_ms": host_ms,
           "step_device_ms": busy, "profiled_host_ms": prof_host_ms,
           "idle_share": None if busy is None else 1 - busy / prof_host_ms,
           "profile_check": check, "top_items": _top(items, 8)}
    if timed_sites:
        out["sites"] = {
            f"{name}:{mode}:{site}": _hybrid_site_timing(name, inputs)
            for name, site, inputs in _gnn_record(m, mode, 1)
            if site in timed_sites}
    return out


def phase_gnn() -> dict:
    """The distributed GCN at benchmarks/gnn_ab.py:51-70's shape (20,000
    nodes, mean degree 16, 64 features and hidden, 8 classes, lr 0.5) in
    the cases broadcast, pull, halo and halo_reorder (the graph relabeled
    by locality_reorder for GNN_S ranks), at one rank in this process and
    at GNN_S ranks sharing the card over gloo (`gnn_rank`, started first
    and run beside the one-rank checks). Gates: each case's kernel path
    against the plain versions of K1 and K3, at one rank and at GNN_S,
    and its first logits against the float64 scipy.sparse forward
    (`_gnn_case`); the GNN_S-rank first logits, losses and parameters
    against the one-rank run's within GNN_TOL, the ranks' losses equal,
    overflow 0; 60 epochs beating the feature-only probe
    (`_gnn_learning`); each mode's launches a step at both.
    Prints the collective bytes a step at GNN_S ranks by kind and the
    reductions against broadcast (gnn_ab.py:98-101), host ms and device
    busy a step at one rank, and K1 and K3 timed at every site of the
    halo and pull steps (halo's exchange sites from rank 0's inputs at
    GNN_S ranks)."""
    from herald_tpu_torch.gnn import locality_reorder, relabel_graph
    _free()
    t0 = time.perf_counter()
    g = _gnn_graph()
    g_re = relabel_graph(g, locality_reorder(g, GNN_S))
    graph_s = time.perf_counter() - t0
    graphs = {"graph": g, "graph_reorder": g_re}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        for name, gr in graphs.items():
            np.savez(tmp / f"{name}.npz", num_nodes=gr.num_nodes,
                     **{f: getattr(gr, f) for f in GNN_GRAPH})
        t1 = time.perf_counter()
        logs = [open(tmp / f"gnn{r}.log", "w") for r in range(GNN_S)]
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--gnn-rank",
             str(r), "--gnn-dir", str(tmp)], cwd=ROOT, stdout=logs[r],
            stderr=subprocess.STDOUT) for r in range(GNN_S)]
        done = False
        try:
            one = {case: _gnn_case(g_re if case == "halo_reorder" else g,
                                   case) for case in GNN_CASES}
            learning = _gnn_learning(g)
            for p in procs:
                p.wait(timeout=max(1.0, 400 - (time.perf_counter() - t1)))
            done = True
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        ranks_s = time.perf_counter() - t1
        for r, p in enumerate(procs):
            if not done or p.returncode != 0:
                raise AssertionError(
                    f"gnn rank {r} exited {p.returncode}:\n"
                    f"{(tmp / f'gnn{r}.log').read_text()[-4000:]}")
        res = [torch.load(tmp / f"gnn{r}.pt", weights_only=False)
               for r in range(GNN_S)]
    ranks = {}
    for case in GNN_CASES:
        a, b = res[0][case], one[case]
        err = _gnn_errs(a, b)
        same = all(np.array_equal(r[case]["losses"], a["losses"])
                   for r in res)
        if max(err.values()) > GNN_TOL or a["overflow"] or not same:
            raise AssertionError(f"gnn {case}: {GNN_S} ranks against one: "
                                 f"{err}, overflow {a['overflow']}, ranks "
                                 f"equal {same}")
        mode = "halo" if case == "halo_reorder" else case
        for r in res:
            plain = r[case]["plain_kernels"]
            if max(plain.values()) > GNN_TOL or r[case]["plain_overflow"]:
                raise AssertionError(f"gnn {case}: at {GNN_S} ranks the "
                                     f"kernel path differs from the plain "
                                     f"versions of K1 and K3: {plain}")
            if r[case]["launches"] != _gnn_per_step(mode, GNN_S):
                raise AssertionError(f"gnn {case}: a step at {GNN_S} ranks "
                                     f"launched {r[case]['launches']}, "
                                     f"expected "
                                     f"{_gnn_per_step(mode, GNN_S)}")
        by_kind = {k: v for k, v in a["bytes"].items()
                   if k != "count" and v}
        ranks[case] = {"one_rank_err": err, "overflow": 0,
                       "plain_kernels": [r[case]["plain_kernels"]
                                         for r in res],
                       "launches": {k: v for k, v in a["launches"].items()
                                    if v},
                       "first_last_loss": a["losses"][[0, -1]].tolist(),
                       "collective_bytes": {**by_kind,
                                            "count": a["bytes"]["count"]},
                       "total_collective_bytes": sum(by_kind.values()),
                       "halo_rows": a["halo_rows"]}
    total = {c: ranks[c]["total_collective_bytes"] for c in GNN_CASES}
    # every site of the halo step; the pull step's exchange sites (its
    # aggregation's are the halo step's shapes); broadcast's are halo's
    halo_sites = {site for _, site in _gnn_sites("halo")}
    timing = {"halo": _gnn_timing(one["halo"]["model"], "halo", halo_sites),
              "pull": _gnn_timing(one["pull"]["model"], "pull", {
                  site for _, site in _gnn_sites("pull")} - halo_sites),
              "broadcast": _gnn_timing(one["broadcast"]["model"],
                                       "broadcast")}
    # halo's exchange sites exist only over GNN_S ranks: rank 0's inputs,
    # timed here with the card to this process
    exchange_sites = {
        key: _hybrid_site_timing(key.split(":")[0], [
            [a.to(DEVICE) if isinstance(a, torch.Tensor) else a
             for a in args] for args in inputs])
        for key, inputs in res[0]["halo"]["halo_site_inputs"].items()}
    out = {"phase": "gnn", "nodes": g.num_nodes, "edges": int(len(g.src)),
           "mean_degree": len(g.src) / g.num_nodes,
           "widths": [GNN_WIDTH, GNN_WIDTH, GNN_CLASSES], "lr": 0.5,
           "graph_s": graph_s, "ranks_command_s": ranks_s,
           "backend": res[0]["backend"], "world_size": GNN_S,
           "one_rank": {c: {"plain_kernels": one[c]["plain_kernels"],
                            "oracle_max_abs_err": one[c]["oracle_max_abs_err"],
                            "first_last_loss": one[c]["losses"][[0, -1]]
                            .tolist()}
                        for c in GNN_CASES},
           "ranks": ranks,
           "halo_vs_broadcast_bytes_reduction":
               total["broadcast"] / max(total["halo"], 1),
           "halo_reorder_vs_broadcast_bytes_reduction":
               total["broadcast"] / max(total["halo_reorder"], 1),
           "learning": learning,
           "steps": {m: {k: v for k, v in t.items() if k != "sites"}
                     for m, t in timing.items()}}
    out["kernel_sites"] = {**timing["halo"]["sites"], **exchange_sites,
                           **timing["pull"]["sites"]}
    emit({**out, "kernel_sites": {k: {x: v[x] for x in (
        "kernel_device_ms", "kernel_ms", "plain_device_ms", "plain_ms",
        "library_device_ms", "library_ms", "bound_ms")} for k, v in
        out["kernel_sites"].items()}})
    out["launches"] = {m: t["launches"] for m, t in timing.items()}
    return out


def _times(k: dict) -> dict:
    """A timing's summary keys; K1's and K2's also carry the route they
    replaced and the call before it (K1 on unique ids in bf16, K2 without
    lr)."""
    out = {"ms": k["kernel_ms"], "device_ms": k["kernel_device_ms"],
           "plain_ms": k["plain_ms"],
           "plain_device_ms": k["plain_device_ms"],
           "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
           "library_ms": k["library_ms"],
           "library_device_ms": k["library_device_ms"]}
    out.update({key: k[key] for key in ("replaced_ms", "replaced_device_ms",
                                        "without_lr") if key in k})
    if "unique_ids" in k:
        out["unique_ids"] = _times(k["unique_ids"])
    return out


def _entry(name, route_src, replaces, by_path, k) -> dict:
    """One kernel's line of the summary; K1, K2 and K3 carry the same
    numbers at dfm's width 513 under "dfm", K3 at FAE's hot sum under
    "fae_hot_sum", K4's forms at FAE's shape under "fae" (the data's hot
    share, then half of it)."""
    out = {"name": name, "route": "cuda",
           "source": f"herald_tpu_torch/ops/kernels/csrc/{route_src}",
           "replaces": f"herald_tpu/ops/pallas/kernels.py:{replaces}",
           "launches": sum(by_path.values()), "launches_by_path": by_path,
           "max_abs_err": k["max_abs_err"], **_times(k)}
    if "dfm" in k:
        out["dfm"] = _times(k["dfm"])
    if "fae_hot_sum" in k:
        out["fae_hot_sum"] = _times(k["fae_hot_sum"])
    if "fae" in k:
        out["fae"] = [{**_times(f), "hot_share": f["hot_share"]}
                      for f in k["fae"]]
    for key in ("hybrid", "hybrid_fae", "hybrid_scheduled", "hybrid_tp",
                "gnn"):
        if key in k:
            out[key] = {site: {**_times(v), "max_abs_err": v["max_abs_err"]}
                        for site, v in k[key].items()}
    return out


def phase_kernel_dfm_width(table: torch.Tensor, batches, positions,
                           inverses, k1, k2) -> None:
    """K1 and K2 timed at dfm's width on the full 513-wide bf16 table, as
    at wdl's: K1 by position with f32 output (each launch on the 26,624
    ids of another dfm batch) beside the route it replaced, and on the
    batch's unique ids in bf16; K2 on the unique ids with and without lr
    (their 513-wide correctness cases ran in kernel:embedding_gather and
    kernel:rows_scatter_add)."""
    k1["dfm"] = {**_position_timing(table, positions, batches, inverses),
                 "unique_ids": _gather_timing(table, batches)}
    k2["dfm"] = _scatter_timing(table, batches)
    emit({"phase": "kernel:dfm_width", "embedding_gather": k1["dfm"],
          "rows_scatter_add": k2["dfm"]})


# the onnx phase: steps trained before the export, held-out batches
# scored by the file and by Engine.predict, the tolerance of
# tests/test_onnx.py:114-115, and the dfm export's row cut (its f32 table
# at full size would be 69 GB)
ONNX_STEPS, ONNX_BATCHES = 8, 2
ONNX_RTOL, ONNX_ATOL = 1e-4, 1e-6
DFM_ONNX_ROWS = 1 << 20


def _dfm_cfg() -> HeraldConfig:
    return HeraldConfig(model=DFM, batch_size=DFM_BATCH,
                        embedding_dim=DFM_EMB, table_dtype=torch.bfloat16,
                        learning_rate=0.01)


def _mem_available() -> int:
    """The host's MemAvailable, bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def phase_onnx(eng: Engine, state: TrainState, label: str = "onnx",
               rows: int = None, per_step: dict = None) -> dict:
    """ONNX export of a state trained on the card (`herald_tpu_torch.onnx`,
    the launcher's `--export-onnx`): ONNX_STEPS steps of train_epoch (the
    captured path) on ids below `rows`, then the held-out batches through
    Engine.predict, both with every kernel count set to 0 before and read
    after; then `export_state` of the whole table (or, with `rows`,
    `export_inference` of its first `rows` rows: a cut) into the build
    directory, `OnnxModel.load` of the file (mapped, not read), its scores
    of the held-out batches against predict's within ONNX_RTOL and
    ONNX_ATOL, and the file deleted. A table whose f32 file would not fit
    the free disk (with 4 GB to spare) is cut to the rows that fit, and
    the line says so. Prints the file's bytes, export_s, load_s, the
    scoring ms, the free disk before the export and the host's
    MemAvailable."""
    from herald_tpu_torch.onnx import OnnxModel, export_inference, \
        export_state
    per_step = per_step or {"embedding_gather": 1, "hot_onehot_push": 1,
                            "rows_scatter_add": 1, "unique_fill": 1}
    B, W = eng.cfg.batch_size, eng.width
    rows = rows or eng.num_rows
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(build.BUILD_DIR).free
    cut = None
    if 4 * rows * W + (4 << 30) > free:
        rows = max(1, (free - (4 << 30)) // (4 * W))
        cut = (f"the f32 file of {4 * (rows or 1) * W} bytes needs more "
               f"than the {free} bytes of free disk less 4 GB")
    n = (ONNX_STEPS + ONNX_BATCHES) * B
    dense, sparse, labels = synthetic_ctr_data(eng.model.spec, n, seed=7,
                                               num_rows=rows)
    chunk = _stage(dense, sparse, labels, 0, ONNX_STEPS, B)
    torch.cuda.synchronize()
    for kern in KERNELS.values():
        kern.launches = 0
    state, stats = eng.train_epoch(state, *chunk, steps=ONNX_STEPS)
    held = [(dense[lo:lo + B], sparse[lo:lo + B])
            for lo in range(ONNX_STEPS * B, n, B)]
    want = np.concatenate([eng.predict(state, d, s).cpu().numpy()
                           for d, s in held])
    launches = {name: kern.launches for name, kern in KERNELS.items()}
    expect = _want(per_step, ONNX_STEPS)
    expect["embedding_gather"] += ONNX_BATCHES
    if "fm_second_order" in per_step:
        expect["fm_second_order"] += ONNX_BATCHES
    if launches != expect:
        raise AssertionError(f"{label}: the path launched {launches}, "
                             f"expected {expect}")
    losses = stats["loss"].cpu()
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"{label}: non-finite training loss")
    mem = _mem_available()
    path = build.BUILD_DIR / f"{label.replace(':', '_')}.{os.getpid()}.onnx"
    try:
        t0 = time.perf_counter()
        if rows == eng.num_rows:
            export_state(eng, state, str(path))
        else:
            export_inference(eng.model, state.dense, state.table[:rows],
                             str(path), batch_size=B)
        export_s = time.perf_counter() - t0
        size = path.stat().st_size
        t0 = time.perf_counter()
        om = OnnxModel.load(str(path))
        load_s = time.perf_counter() - t0
        score_ms, got = [], []
        for d, s in held:
            t0 = time.perf_counter()
            (p,) = om(sparse_ids=s.astype(np.int64),
                      dense_x=d.astype(np.float32))
            score_ms.append((time.perf_counter() - t0) * 1e3)
            got.append(p)
        got = np.concatenate(got)
        table_shape = list(om.initializers["embedding_table"].shape)
        del om
    finally:
        path.unlink(missing_ok=True)
    diff = float(np.abs(got - want).max())
    if got.shape != want.shape or not np.allclose(got, want, rtol=ONNX_RTOL,
                                                  atol=ONNX_ATOL):
        raise AssertionError(f"{label}: the file's scores differ from "
                             f"predict by up to {diff}")
    if table_shape != [rows, W] or size <= 4 * rows * W:
        raise AssertionError(f"{label}: a {size}-byte file with a "
                             f"{table_shape} table")
    out = {"phase": label, "model": eng.model.name, "batch": B,
           "table_shape": list(state.table.shape),
           "table_dtype": str(state.table.dtype),
           "exported_rows": rows, "exported_width": W,
           "row_cut": cut or (None if rows == eng.num_rows else
                              f"the first {rows} rows (the f32 table of "
                              f"all {eng.num_rows} would be "
                              f"{4 * eng.num_rows * W} bytes)"),
           "trained_steps": ONNX_STEPS, "launches": launches,
           "loss_last": float(losses[-1]), "file_bytes": size,
           "export_s": export_s, "export_gb_per_s": size / export_s / 1e9,
           "load_s": load_s, "score_ms": score_ms,
           "scored_rows": int(got.size), "max_abs_diff": diff,
           "rtol": ONNX_RTOL, "atol": ONNX_ATOL,
           "free_disk_bytes_before": free, "mem_available_bytes": mem}
    emit(out)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=("scheduled", "scheduled:pinned",
                                        "train", "fae",
                                        "assigned", "hybrid", "feed",
                                        "onnx", "gnn", "tp", "unique",
                                        "pool"),
                    help="the device and build phases and this one alone "
                         "(scheduled: scheduled and scheduled:memo; "
                         "fae: fae and launch:fae; assigned: assigned and "
                         "launch:assigned; hybrid: hybrid and "
                         "launch:hybrid; feed: launch:feed on --samples "
                         "data; onnx: onnx and onnx:dfm; gnn: gnn; tp: "
                         "hybrid:tp, autoshard, pipeline and launch:tp; "
                         "unique: kernel:unique_fill; pool: "
                         "kernel:gather_pool_rows and train:dlrm)")
    ap.add_argument("--root", help="import herald_tpu_torch from this "
                                   "checkout (with --phase)")
    ap.add_argument("--hybrid-rank", type=int,
                    help="run one rank of the hybrid phase (its parent "
                         "starts them)")
    ap.add_argument("--hybrid-dir", help="the hybrid phase's directory")
    ap.add_argument("--gnn-rank", type=int,
                    help="run one rank of the gnn phase (its parent starts "
                         "them)")
    ap.add_argument("--gnn-dir", help="the gnn phase's directory")
    ap.add_argument("--tp-rank", type=int,
                    help="run one rank of the tp phase (its parent starts "
                         "them)")
    ap.add_argument("--tp-size", type=int, help="the tp phase's ranks")
    ap.add_argument("--tp-dir", help="the tp phase's directory")
    args = ap.parse_args()
    if args.tp_rank is not None:
        tp_rank(args.tp_rank, args.tp_size, Path(args.tp_dir))
        return
    if args.hybrid_rank is not None:
        hybrid_rank(args.hybrid_rank, Path(args.hybrid_dir))
        return
    if args.gnn_rank is not None:
        gnn_rank(args.gnn_rank, Path(args.gnn_dir))
        return
    smi = phase_device()
    if args.root:
        pkg = Path(herald_tpu_torch.__file__).resolve().parents[1]
        if not args.phase or pkg != Path(args.root).resolve():
            raise SystemExit(f"chip_smoke: --root needs --phase and "
                             f"imported {pkg}")
    phase_build()
    cfg = HeraldConfig(model="wdl_criteo", batch_size=BATCH,
                       embedding_dim=EMB, table_dtype=torch.bfloat16)
    if args.phase == "scheduled":
        phase_scheduled()
    elif args.phase == "scheduled:pinned":
        phase_scheduled_pinned()
    elif args.phase == "train":
        eng = Engine(cfg, table_rows=FULL_ROWS, device="cuda")
        phase_train(eng, eng.init_state(0))
    elif args.phase == "fae":
        phase_fae()
        _free()
        phase_launch_fae()
    elif args.phase == "assigned":
        eng = Engine(cfg, table_rows=FULL_ROWS, device="cuda")
        phase_assigned(eng, eng.init_state(0))
        del eng
        _free()
        phase_launch_assigned()
    elif args.phase == "hybrid":
        phase_hybrid()
        phase_launch_hybrid()
    elif args.phase == "feed":
        phase_launch_feed(raw=False)
    elif args.phase == "gnn":
        phase_gnn()
    elif args.phase == "tp":
        phase_tp()
        phase_launch_tp()
    elif args.phase == "unique":
        phase_kernel_unique()
    elif args.phase == "pool":
        kp = phase_kernel_pool()
        dl = phase_train_dlrm()
        emit({"kernels": [_pool_entry(kp, {
            "train:dlrm": dl["launches"]["gather_pool_rows"],
            "eval:dlrm": dl["eval_launches"]["gather_pool_rows"]})]})
    elif args.phase == "onnx":
        eng = Engine(cfg, table_rows=FULL_ROWS, device="cuda")
        phase_onnx(eng, eng.init_state(0))
        del eng
        _free()
        eng = Engine(_dfm_cfg(), table_rows=FULL_ROWS, device="cuda")
        phase_onnx(eng, eng.init_state(0), "onnx:dfm", DFM_ONNX_ROWS,
                   DFM_TRAIN)
    if args.phase:
        emit({"phase": "profiler", **PROFILER})
        print(smi, flush=True)
        return
    eng = Engine(cfg, table_rows=FULL_ROWS, device="cuda")
    state = eng.init_state(0)
    assert tuple(state.table.shape) == (33_762_584, EMB)
    # 64 serving batches of synthetic_ctr_data(seed=0): their unique ids
    # (K1's and K2's shape) and their inverses (K3's)
    _, sparse, _ = synthetic_ctr_data(eng.model.spec, 64 * BATCH, seed=0,
                                      num_rows=FULL_ROWS)
    batches, inverses, uniques, positions = _inverses(sparse, BATCH, 64)
    # 8 dfm batches (1,024 rows) of the same data, for K3 at dfm's shape
    # now and K1, K2 and K5 once the dfm table exists
    _, dfm_sparse, _ = synthetic_ctr_data(get_model(DFM).spec,
                                          8 * DFM_BATCH, seed=0,
                                          num_rows=FULL_ROWS)
    dfm_batches, dfm_inverses, dfm_uniques, dfm_positions = _inverses(
        dfm_sparse, DFM_BATCH, 8)
    k1 = phase_kernel(state.table, batches, positions, inverses)
    k3 = phase_kernel_push(inverses, uniques, dfm_inverses, dfm_uniques)
    ku = phase_kernel_unique()
    k2 = phase_kernel_scatter(state.table, batches)
    serve = phase_serve(eng, state)
    phase_checkpoint()
    train = phase_train(eng, state)
    assigned, state = phase_assigned(eng, state)
    # the serving handoff of a trained full-width state: its whole table
    phase_onnx(eng, state)
    del state, eng
    _free()
    # the multi-hot model's kernel at the cell's 63.58 GB table, then its
    # train and eval paths
    kp = phase_kernel_pool()
    dlrm = phase_train_dlrm()
    phase_train_adam()
    _free()
    phase_launch()
    phase_launch_assigned()
    fae = phase_fae()
    k3["fae_hot_sum"] = fae["hot_sum"]
    _free()
    phase_launch_fae()
    sched = phase_scheduled()
    pinned, hot, uniqs, positions = phase_scheduled_pinned()
    k4, k4_add = phase_kernel_hot_gather(hot, uniqs, positions)
    del hot, uniqs, positions
    _free()
    phase_launch_scheduled()
    phase_launch_feed(raw=True)
    _free()
    # the row-sharded exchange: two ranks sharing this card over gloo
    hybrid = phase_hybrid()
    for k, name in ((k1, "embedding_gather"), (k3, "hot_onehot_push"),
                    (k4_add, "hot_onehot_gather_add_")):
        for key, sites in (("hybrid", hybrid["kernel_sites"]),
                           ("hybrid_fae", hybrid["fae"]["kernel_sites"]),
                           ("hybrid_scheduled",
                            hybrid["scheduled"]["kernel_sites"])):
            mine = {site.split(":")[1]: v for site, v in sites.items()
                    if site.startswith(name + ":")}
            if mine:
                k[key] = mine
    phase_launch_hybrid()
    # the distributed GCN: K1 and K3 at its sites, one rank and two
    gnn = phase_gnn()
    for k, name in ((k1, "embedding_gather"), (k3, "hot_onehot_push")):
        k["gnn"] = {site.split(":", 1)[1]: v
                    for site, v in gnn["kernel_sites"].items()
                    if site.startswith(name + ":")}
    _free()
    # tensor and pipeline parallel: ranks sharing this card over gloo
    tp = phase_tp()
    for k, name in ((k1, "embedding_gather"), (k3, "hot_onehot_push")):
        k["hybrid_tp"] = {site.split(":")[1]: v
                          for site, v in tp[4]["kernel_sites"].items()
                          if site.startswith(name + ":")}
    phase_launch_tp()
    _free()

    # DeepFM at its own full width: the 33,762,584 x 513 bf16 table
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(_dfm_cfg(), table_rows=FULL_ROWS, device="cuda")
    state = eng.init_state(0)
    assert tuple(state.table.shape) == (33_762_584, DFM_EMB + 1)
    k5, k5b = phase_kernel_fm(state.table, dfm_sparse)
    _free()
    phase_kernel_dfm_width(state.table, dfm_batches, dfm_positions,
                           dfm_inverses, k1, k2)
    del dfm_batches, dfm_positions, dfm_inverses
    _free()
    serve_dfm = phase_serve(eng, state, "serve:dfm", plain_dfm_apply,
                            DFM_SERVE, tol=1e-5)
    train_dfm = phase_train(eng, state, "train:dfm", 32, plain_dfm_apply,
                            DFM_TRAIN)
    phase_onnx(eng, state, "onnx:dfm", DFM_ONNX_ROWS, DFM_TRAIN)
    del state, eng
    _free()
    phase_launch_dfm()
    sched_dfm = phase_scheduled_dfm()

    paths = {"serve": serve["launches"], "train": train["launches"],
             "assigned": assigned["launches"], "fae": fae["launches"],
             "scheduled": sched["launches_tape"],
             "scheduled:pinned": pinned["launches"],
             "hybrid": hybrid["launches"],
             "hybrid:assigned": hybrid["assigned"]["launches"],
             "hybrid:fae": hybrid["fae"]["launches"],
             "hybrid:scheduled": hybrid["scheduled"]["launches"],
             "hybrid:tp:2": tp[2]["launches"],
             "hybrid:tp:4": tp[4]["launches"],
             "gnn:halo": gnn["launches"]["halo"],
             "gnn:pull": gnn["launches"]["pull"],
             "gnn:broadcast": gnn["launches"]["broadcast"],
             "serve:dfm": serve_dfm["launches"],
             "train:dfm": train_dfm["launches"],
             "scheduled:dfm": sched_dfm["launches_tape"],
             "train:dlrm": dlrm["launches"],
             "eval:dlrm": dlrm["eval_launches"]}

    def by_path(name):
        return {p: counts.get(name, 0) for p, counts in paths.items()}

    emit({"kernels": [
        _entry("embedding_gather", "embedding_gather.cu", 104,
               by_path("embedding_gather"), k1),
        _entry("hot_onehot_push", "hot_onehot_push.cu", 274,
               by_path("hot_onehot_push"), k3),
        _entry("rows_scatter_add", "rows_scatter_add.cu", 183,
               by_path("rows_scatter_add"), k2),
        _entry("hot_onehot_gather", "hot_onehot_gather.cu", 234,
               by_path("hot_onehot_gather"), k4),
        _entry("hot_onehot_gather_add_", "hot_onehot_gather.cu", 234,
               by_path("hot_onehot_gather_add_"), k4_add),
        _entry("fm_second_order", "fm_second_order.cu", 309,
               by_path("fm_second_order"), k5),
        _entry("fm_second_order_backward", "fm_second_order.cu", 309,
               by_path("fm_second_order_backward"), k5b),
        {"name": "unique_fill", "route": "cuda",
         "source": "herald_tpu_torch/ops/kernels/csrc/unique_fill.cu",
         "replaces": "none: jnp.unique (herald_tpu/train/engine.py:301-302)",
         "launches": sum(by_path("unique_fill").values()),
         "launches_by_path": by_path("unique_fill"), "cases": ku["cases"],
         "wdl_step": ku["wdl_step"], "capacity": ku["capacity"]},
        _pool_entry(kp, by_path("gather_pool_rows"))]})
    emit({"phase": "profiler", **PROFILER})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
