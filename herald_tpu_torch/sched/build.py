"""Build the native host libraries with g++ and locate them for ctypes.

The cache planner (`csrc/herald_cache_planner.cc`), the lookahead
sample scheduler (`csrc/herald_sched.cc`) and the raw-data preprocessor
(`csrc/herald_preproc.cc`), each hashed with `csrc/herald_common.h`, are
host code that knows no framework. The port compiles the same sources
itself, into `herald_tpu_torch/_build/libherald_<name>.<hash>.so`, where
the hash covers the sources and the compiler flags, so an edited source
builds a new library beside the old one. It never loads a library built
by another package.

Each build writes a temporary file named for its process and then
renames it into place, so concurrent builds never share a path.
The hash is also compiled in (`-DHERALD_ABI_HASH`) and checked against
`herald_abi_hash()` at load: ctypes has no linker, and a library that did
not come from these sources would otherwise fail as memory corruption.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCE = "herald_cache_planner.cc"          # the planner
SCHED_SOURCE = "herald_sched.cc"            # the lookahead scheduler
PREPROC_SOURCE = "herald_preproc.cc"        # the raw-data parser
COMMON = "herald_common.h"
# -mcx16/-latomic: the planner's 128-bit residency words (64 workers) use
# 16-byte atomic read-modify-writes (cmpxchg16b)
CXXFLAGS = ("-O3", "-std=c++17", "-mcx16", "-shared", "-fPIC")
LIBS = ("-lpthread", "-latomic")

_lock = threading.Lock()


def abi_hash(source: str = SOURCE) -> Tuple[str, int]:
    """(hex digest for the file name, positive 62-bit value compiled into
    the library) of `source`, the common header and the flags."""
    h = hashlib.sha256()
    for name in (source, COMMON):
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(CXXFLAGS + LIBS).encode())
    digest = h.digest()
    return h.hexdigest()[:12], int.from_bytes(digest[:8], "little") & (
        2 ** 62 - 1)


def _lib_abi(path: Path) -> int:
    fn = ctypes.CDLL(str(path)).herald_abi_hash
    fn.restype = ctypes.c_long
    return int(fn())


def _lib_path(source: str, name: str) -> str:
    """Compile `source` into libherald_<name> if this tree has no library
    of these sources yet, check its ABI hash, and return its path. Raises
    with g++'s output if the build fails."""
    tag, value = abi_hash(source)
    lib = BUILD_DIR / f"libherald_{name}.{tag}.so"
    with _lock:
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = ["g++", *CXXFLAGS, f"-DHERALD_ABI_HASH={value}L",
                   "-o", str(tmp), str(CSRC / source), *LIBS]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"{name} build failed (g++ exit "
                        f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, lib)
            finally:
                tmp.unlink(missing_ok=True)
        got = _lib_abi(lib)
        if got != value:
            raise RuntimeError(
                f"{lib} reports ABI hash {got}, but the sources in {CSRC} "
                f"hash to {value}: it was not built from them")
    return str(lib)


def planner_lib_path() -> str:
    """The cache planner's library (`_lib_path`)."""
    return _lib_path(SOURCE, "planner")


def sched_lib_path() -> str:
    """The lookahead scheduler's library (`_lib_path`)."""
    return _lib_path(SCHED_SOURCE, "sched")


def preproc_lib_path() -> str:
    """The raw-data preprocessor's library (`_lib_path`)."""
    return _lib_path(PREPROC_SOURCE, "preproc")
