"""Restart-on-failure supervisor around the training launcher (port of
`herald_tpu/launch/supervise.py`).

A lost card or process ends every rank of a job, so the unit of recovery
is the job: periodic checkpoints (--ckpt-every), a resume that continues
at the saved step (--resume; the planner and the scheduler fast-forward),
and this supervisor, which runs the launcher again until it finishes.

    python -m herald_tpu_torch.launch.supervise --ckpt-dir DIR \
        [--ckpt-every N --max-restarts R --backoff SECONDS] -- \
        --model wdl_criteo --scheduled --nepoch 1 ... [--device cuda|cpu]

The child is one process of `python -m herald_tpu_torch.launch` with the
flags after `--`; the supervisor adds --ckpt and --ckpt-every to every
launch and --resume when the checkpoint directory holds a checkpoint
(LATEST or a manifest). Exit code 0 stops; any other restarts it after
`--backoff` seconds, doubled on each consecutive failure, up to
`--max-restarts` restarts.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="herald_tpu_torch.launch.supervise",
        description="restart-on-failure supervisor for the training "
                    "launcher")
    p.add_argument("--ckpt-dir", required=True,
                   help="checkpoint dir (given to the child as --ckpt, and "
                        "as --resume once it holds a checkpoint)")
    p.add_argument("--ckpt-every", type=int, default=50,
                   help="given to the child (steps between checkpoints: "
                        "the steps trained again after a crash)")
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--backoff", type=float, default=2.0,
                   help="base seconds; doubles per consecutive failure")
    p.add_argument("child_args", nargs=argparse.REMAINDER,
                   help="-- followed by herald_tpu_torch.launch flags")
    return p


def _has_checkpoint(path: str) -> bool:
    # the versioned layout names its newest complete save in LATEST; a
    # flat layout keeps manifest.json at the top
    return (os.path.exists(os.path.join(path, "LATEST"))
            or os.path.exists(os.path.join(path, "manifest.json")))


def supervise(argv=None) -> int:
    args = build_parser().parse_args(argv)
    child = [a for a in args.child_args if a != "--"]
    restarts = 0
    while True:
        cmd = [sys.executable, "-m", "herald_tpu_torch.launch", *child,
               "--ckpt", args.ckpt_dir,
               "--ckpt-every", str(args.ckpt_every)]
        if _has_checkpoint(args.ckpt_dir):
            cmd += ["--resume", args.ckpt_dir]
        print(f"[supervise] launch (attempt {restarts + 1}): "
              + " ".join(cmd[2:]), file=sys.stderr, flush=True)
        rc = subprocess.call(cmd)
        if rc == 0:
            return 0
        restarts += 1
        if restarts > args.max_restarts:
            print(f"[supervise] giving up after {args.max_restarts} "
                  f"restarts (last rc={rc})", file=sys.stderr, flush=True)
            return rc
        delay = args.backoff * (2 ** (restarts - 1))
        print(f"[supervise] child died rc={rc}; restarting from "
              f"checkpoint in {delay:.1f}s", file=sys.stderr, flush=True)
        time.sleep(delay)


if __name__ == "__main__":
    sys.exit(supervise())
