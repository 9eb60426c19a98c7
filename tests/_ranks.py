"""Run a function on S CPU ranks of a gloo group, each a spawned process,
for the port's multi-rank tests. The group meets through a `file://`
store under the test's directory (no port is opened), and the whole run
has a timeout: a rank that hangs fails the test that spawned it."""

import time

import pytest
import torch.multiprocessing as mp


def run_ranks(fn, S: int, tmp_path, *args, timeout: float = 150.0) -> None:
    """fn(rank, S, init_method, *args) on S spawned processes; raises the
    first rank's error, and fails the test when the ranks outlast
    `timeout` seconds (every process is killed then)."""
    store = tmp_path / f"store{S}"
    ctx = mp.start_processes(fn, args=(S, f"file://{store}", *args),
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
