"""No module a run loads has jax, jaxlib, flax or herald_tpu as its
top-level name, compared whole (herald_tpu_torch begins with herald_tpu
and is allowed); the reference imports nothing of the program."""

import ast
import subprocess
import sys
import types

from conftest import ROOT

from portbench import harness

RUN = """
import io, json, sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import TINY
from portbench import harness
bench = json.loads(open({bench!r}).read())
run = harness.Run(bench, "wdl_criteo.sched_churn", 3, 0.2, True,
                  device="cpu", overrides=TINY)
harness.execute(run, time.perf_counter(), out=io.StringIO(),
                err=io.StringIO())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax_nor_the_jax_package():
    code = RUN.format(root=str(ROOT), tests=str(ROOT / "portbench/tests"),
                      bench=str(ROOT / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True).stdout
    tops = set(__import__("json").loads(out.strip().splitlines()[-1]))
    assert "herald_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "herald_tpu"}


def test_whole_name_compare(monkeypatch):
    monkeypatch.setitem(sys.modules, "herald_tpu_torch_fake",
                        types.ModuleType("herald_tpu_torch_fake"))
    assert "herald_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "herald_tpu.sub",
                        types.ModuleType("herald_tpu.sub"))
    assert harness.forbidden_modules() == ["herald_tpu"]


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)]
        assert not any(x.split(".")[0] in ("herald_tpu_torch", "herald_tpu",
                                            "jax") for x in names), path
