"""Run a function on S CPU ranks of a gloo group, each a spawned process,
for the port's multi-rank tests. The group meets through a `file://`
store under the test's directory (no port is opened), every rank leaves
the group before it exits, and the whole run has a timeout: a rank that
hangs fails the test that spawned it.
`launch_rank` runs the port's launcher on one rank from a saved state."""

import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank, fn, *args) -> None:
    """fn(rank, *args), then every rank leaves the group together: a rank
    that exits with its gloo group still up can abort as its connections
    are torn down at the interpreter's exit."""
    fn(rank, *args)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def run_ranks(fn, S: int, tmp_path, *args, timeout: float = 150.0) -> None:
    """fn(rank, S, init_method, *args) on S spawned processes; raises the
    first rank's error, and fails the test when the ranks outlast
    `timeout` seconds (every process is killed then)."""
    store = tmp_path / f"store{S}"
    ctx = mp.start_processes(_rank, args=(fn, S, f"file://{store}", *args),
                             nprocs=S, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"{S} ranks of {fn.__name__} ran past "
                            f"{timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def launch_rank(rank, S, init, out, argv) -> None:
    """One rank of `herald_tpu_torch.launch --comm hybrid --device cpu
    ARGV`, started from the state in out/init.r<rank>.pt (a TrainState's,
    a FaeTrainState's or a CachedTrainState's fields, as
    `bridge.shard_state` gives them) in place of the engine's own init;
    the report goes to out/report.r<rank>.pt. Imports no JAX."""
    torch.set_num_threads(1)
    from herald_tpu_torch.launch import cli
    from herald_tpu_torch.parallel import comm
    from herald_tpu_torch.train.cached import CachedEngine, CachedTrainState
    from herald_tpu_torch.train.engine import Engine, TrainState
    from herald_tpu_torch.train.fae import FaeEngine, FaeTrainState
    comm.setup("cpu", init_method=init, rank=rank, world_size=S)
    saved = torch.load(out / f"init.r{rank}.pt", weights_only=False)
    if "cache" in saved:
        CachedEngine.init_cached_state = \
            lambda self, seed=None: CachedTrainState(**saved)
    elif "hot_table" in saved:
        FaeEngine.init_fae_state = \
            lambda self, seed=None: FaeTrainState(**saved)
    else:
        Engine.init_state = lambda self, seed=None: TrainState(**saved)
    report = cli.run_training(cli.build_parser().parse_args(
        argv + ["--device", "cpu", "--comm", "hybrid"]))
    torch.save(report, out / f"report.r{rank}.pt")
