#!/usr/bin/env python3
"""Drive herald_tpu_torch on one NVIDIA card (H100): build its CUDA kernels
from the sources in this checkout, hold each against its plain PyTorch
version, serve wdl_criteo at full width over HTTP, and print what it
measured.

    python3 chip_smoke.py

Prints one JSON object per line, in this order: device, build,
kernel:embedding_gather, serve, checkpoint, the kernels summary, and last
{"ok": true, "device": {...}}. Every phase that fails raises: the script
then exits non-zero and prints no "ok" line. It needs a CUDA card, nvcc
(CUDA_HOME or /usr/local/cuda) and this checkout; it uses no network
beyond 127.0.0.1.

Full width is the shape of bench.py: batch 256, embedding 128, the
33,762,577-row Criteo table (padded to 33,762,584) in bfloat16, 8.64 GB,
with random weights from a seed.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

from herald_tpu_torch.config import HeraldConfig
from herald_tpu_torch.data import DATASETS, synthetic_ctr_data
from herald_tpu_torch.ops.kernels import (KERNELS, build, embedding_gather,
                                          embedding_gather_ref)
from herald_tpu_torch.serve import Scorer, load_scorer, make_server
from herald_tpu_torch.train.checkpoint import save_checkpoint
from herald_tpu_torch.train.engine import Engine

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory, published peak
FULL_ROWS = DATASETS["criteo"].num_embed_rows      # 33,762,577
BATCH, EMB = 256, 128


def emit(obj) -> None:
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


def device_profile(fn, calls: int):
    """Device time per call of fn(i), from torch.profiler's CUDA activity:
    (total ms, {kernel or copy name: ms}, host ms per call while
    profiled). The total is None where the profiler saw no device
    activity in three tries (a session now and then records none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(calls):
                fn(i)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / calls
        per = {e.key: e.self_device_time_total / 1e3 / calls
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0}
        if per:
            return sum(per.values()), per, host_ms
    return None, per, host_ms


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
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": seconds, "built": sorted(logs),
          "ptxas": ptxas})


def _gather_cases():
    """(label, table, ids) cases on the card; ids as int32 and int64."""
    g = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    for dt in (torch.float32, torch.bfloat16):
        for R, D, N, oob in ((512, 128, 60, 0.0),      # test_pallas_kernels
                             (1001, 13, 300, 0.1),     # R % 8 != 0, tail
                             (100_000, 128, 6656, 0.1),
                             (512, 128, 0, 0.0)):
            table = torch.randn((R, D), generator=g, device="cuda").to(dt)
            ids = rng.integers(0, R, N)
            bad = rng.random(N) < oob
            ids[bad] = np.where(rng.random(bad.sum()) < 0.5,
                                -rng.integers(1, 10 * R, bad.sum()),
                                R + rng.integers(0, 10 * R, bad.sum()))
            for idt in (torch.int32, torch.int64):
                label = f"{str(dt)[6:]} R={R} D={D} N={N} {str(idt)[6:]}"
                yield label, table, torch.as_tensor(ids, dtype=idt,
                                                    device="cuda")


def phase_kernel(table: torch.Tensor, batches) -> dict:
    """K1 against its plain version (bit-exact), then timed at the
    serving shape: the full table, each launch on the unique ids of
    another 256-batch."""
    cases, worst = [], 0.0
    for label, tab, ids in list(_gather_cases()) + [
            ("serving bf16 full table, batch 0", table, batches[0])]:
        got = embedding_gather(tab, ids)
        want = embedding_gather_ref(tab, ids)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max()) \
            if got.numel() else 0.0
        if not torch.equal(got, want):
            raise AssertionError(f"embedding_gather differs from its "
                                 f"plain version ({label}): max {err}")
        worst = max(worst, err)
        cases.append(label)

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
        what: device_profile(lambda i, f=f: f(table, batches[i % k]), k)[0]
        for what, f in (("kernel", embedding_gather),
                        ("plain", embedding_gather_ref),
                        ("library", lambda t, i: torch.index_select(t, 0, i)))}
    out = {"name": "embedding_gather", "cases": len(cases),
           "max_abs_err": worst, "batches": k, "mean_unique_ids": mean_n,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "kernel_device_ms": device_ms["kernel"],
           "plain_device_ms": device_ms["plain"],
           "library_device_ms": device_ms["library"],
           "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "bytes_per_launch": bytes_moved}
    emit({"phase": "kernel:embedding_gather", **out})
    return out


def _request(url, data=None):
    req = urllib.request.Request(
        url, data=None if data is None else json.dumps(data).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@torch.inference_mode()
def reference_scores(eng: Engine, state, dense, sparse) -> np.ndarray:
    """The engine's eval step with K1 replaced by its plain version, padded
    and chunked as the Scorer does."""
    out = []
    for i in range(0, len(sparse), BATCH):
        d, s = dense[i:i + BATCH], sparse[i:i + BATCH]
        m = len(s)
        d = np.concatenate([d, np.repeat(d[-1:], BATCH - m, axis=0)])
        s = np.concatenate([s, np.repeat(s[-1:], BATCH - m, axis=0)])
        ids = torch.as_tensor(s.astype(np.int32), device="cuda")
        uniq, inv = torch.unique(ids.reshape(-1), sorted=True,
                                 return_inverse=True)
        emb = embedding_gather_ref(state.table, uniq)[inv].reshape(
            BATCH, -1, eng.width)
        logits = eng.model.apply(state.dense, emb.float(),
                                 torch.as_tensor(d, device="cuda"))
        out.append(torch.sigmoid(logits)[:m].cpu().numpy())
    return np.concatenate(out)


def phase_serve(eng: Engine, state) -> dict:
    """The main path: HTTP requests, predict latency, throughput and
    evaluate, all through Engine.predict. Kernel counts are zeroed just
    before and read just after."""
    spec = eng.model.spec
    dense, sparse, labels = synthetic_ctr_data(spec, 64 * BATCH, seed=1,
                                               num_rows=FULL_ROWS)
    scorer = Scorer(eng, state)
    srv = make_server(scorer, 0)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    served = {}
    for k in KERNELS.values():
        k.launches = 0
    expected = 0                          # K1 launches: one per batch
    try:
        code, health = _request(url + "/health")
        assert code == 200 and health == {"status": "ok",
                                          "model": "wdl_criteo",
                                          "step": 0, "batch": BATCH}, health
        for n in (1, 256, 600):
            code, resp = _request(url + "/score",
                                  {"dense": dense[:n].tolist(),
                                   "sparse": sparse[:n].tolist()})
            assert code == 200 and resp["n"] == n, (code, resp.get("error"))
            p = np.asarray(resp["probs"], np.float32)
            assert p.shape == (n,) and np.isfinite(p).all() \
                and (p >= 0).all() and (p <= 1).all()
            served[n] = p
            expected += -(-n // BATCH)
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

    d, s = dense[:BATCH], sparse[:BATCH]
    lat = []
    for _ in range(60):
        t0 = time.perf_counter()
        eng.predict(state, d, s)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    expected += 60
    nb = 200
    t0 = time.perf_counter()
    for i in range(nb):
        j = (i % 64) * BATCH
        eng.predict(state, dense[j:j + BATCH], sparse[j:j + BATCH])
    torch.cuda.synchronize()
    ex_s = nb * BATCH / (time.perf_counter() - t0)
    expected += nb
    t0 = time.perf_counter()
    ev = eng.evaluate(state, dense, sparse, labels)
    eval_s = time.perf_counter() - t0
    expected += 64
    launches = {name: k.launches for name, k in KERNELS.items()}
    if launches["embedding_gather"] != expected:
        raise AssertionError(f"embedding_gather launched "
                             f"{launches['embedding_gather']} times on the "
                             f"main path, expected {expected}")
    if not (np.isfinite(ev["auc"]) and np.isfinite(ev["acc"])):
        raise AssertionError(f"evaluate gave {ev}")

    # where one predict's time goes (outside the counted window)
    busy, per, host = device_profile(
        lambda i: eng.predict(state, dense[(i % 64) * BATCH:][:BATCH],
                              sparse[(i % 64) * BATCH:][:BATCH]), 50)
    top = dict(sorted(per.items(), key=lambda kv: -kv[1])[:8])
    profile = {"device_busy_ms": busy, "host_ms_profiled": host,
               "device_idle_share": None if busy is None else 1 - busy / host,
               "top_device_ms": top}

    ref = reference_scores(eng, state, dense[:600], sparse[:600])
    err = float(np.abs(served[600] - ref).max())
    if err > 1e-6:
        raise AssertionError(f"served probs differ from the plain path by "
                             f"{err}")
    for n in (1, 256):
        # the same rows in another request: equal within f32 rounding
        assert np.abs(served[n] - served[600][:n]).max() <= 1e-6, n
    out = {"phase": "serve", "table_shape": list(state.table.shape),
           "table_dtype": str(state.table.dtype),
           "table_gb": state.table.numel() * state.table.element_size()
           / 1e9, "requests": [1, 256, 600], "max_abs_err_vs_plain": err,
           "predict_ms_median": statistics.median(lat),
           "predict_ms_p90": float(np.percentile(lat, 90)),
           "examples_per_s": ex_s, "throughput_batches": nb,
           "evaluate": ev, "evaluate_batches": 64, "evaluate_s": eval_s,
           "launches": launches, "predict_profile": profile,
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
        proc = subprocess.Popen(
            [sys.executable, "-m", "herald_tpu_torch.serve", "--ckpt", ckpt,
             "--config", str(cfg_path), "--rows", str(rows), "--port", "0"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        try:
            seen = []
            for line in proc.stdout:          # until it says where it serves
                seen.append(line)
                m = re.search(r"serving .* at http://127\.0\.0\.1:(\d+)",
                              line)
                if m:
                    break
            else:
                raise AssertionError("serve entry point did not start:\n"
                                     + "".join(seen))
            url = f"http://127.0.0.1:{m.group(1)}"
            code, resp = _request(url + "/score",
                                  {"dense": dense.tolist(),
                                   "sparse": sparse.tolist()})
            assert code == 200, (code, resp)
            cli = np.asarray(resp["probs"], np.float32)
            if not np.array_equal(cli, want):
                raise AssertionError("entry point differs: max "
                                     f"{np.abs(cli - want).max()}")
        finally:
            proc.terminate()
            proc.wait(timeout=60)
            proc.stdout.close()
    emit({"phase": "checkpoint", "rows": rows, "emb": EMB,
          "requests": len(sparse), "identical": True,
          "entry_point": "python -m herald_tpu_torch.serve"})


def main() -> None:
    name = phase_device()
    phase_build()
    cfg = HeraldConfig(model="wdl_criteo", batch_size=BATCH,
                       embedding_dim=EMB, table_dtype=torch.bfloat16)
    eng = Engine(cfg, table_rows=FULL_ROWS, device="cuda")
    state = eng.init_state(0)
    assert tuple(state.table.shape) == (33_762_584, EMB)
    # the unique ids of 64 serving batches of synthetic_ctr_data(seed=0)
    _, sparse, _ = synthetic_ctr_data(eng.model.spec, 64 * BATCH, seed=0,
                                      num_rows=FULL_ROWS)
    batches = [torch.as_tensor(np.unique(sparse[i * BATCH:(i + 1) * BATCH])
                               .astype(np.int32), device="cuda")
               for i in range(64)]
    k1 = phase_kernel(state.table, batches)
    serve = phase_serve(eng, state)
    phase_checkpoint()
    emit({"kernels": [{
        "name": "embedding_gather", "route": "cuda",
        "source": "herald_tpu_torch/ops/kernels/csrc/embedding_gather.cu",
        "replaces": "herald_tpu/ops/pallas/kernels.py:104",
        "launches": serve["launches"]["embedding_gather"],
        "max_abs_err": k1["max_abs_err"], "ms": k1["kernel_ms"],
        "device_ms": k1["kernel_device_ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": k1["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
