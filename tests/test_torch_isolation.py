"""herald_tpu_torch stands alone: it imports neither JAX, ml_dtypes nor
anything of herald_tpu, and its entry points never fall back to the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "herald_tpu")


def _port_sources():
    files = sorted((ROOT / "herald_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_forbidden_imports_in_port_sources():
    files = _port_sources()
    assert len(files) > 10 and all(f.exists() for f in files)
    # the examples are scanned with the rest of the package
    assert {"run_baseline.py", "run_scheduled.py", "run_fae.py"} <= {
        f.name for f in files if f.parent.name == "examples"}
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_serve_imports_with_jax_and_herald_tpu_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'ml_dtypes', 'herald_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import herald_tpu_torch.serve, herald_tpu_torch.bridge\n"
            "import herald_tpu_torch.ops.kernels.build\n"
            "import herald_tpu_torch.launch, herald_tpu_torch.launch.cli\n"
            "import herald_tpu_torch.optim.schedules\n"
            "import herald_tpu_torch.utils.profiler\n"
            "import herald_tpu_torch.train.cached\n"
            "import herald_tpu_torch.ops.kernels.hot_gather\n"
            "import herald_tpu_torch.ops.kernels.fm\n"
            "import herald_tpu_torch.models.dfm, herald_tpu_torch.models.dcn\n"
            "import herald_tpu_torch.models.linear\n"
            "import herald_tpu_torch.models.misc\n"
            "import herald_tpu_torch.sched.build\n"
            "import herald_tpu_torch.sched.planner\n"
            "import herald_tpu_torch.sched.sizing\n"
            "import herald_tpu_torch.sched.replay\n"
            "import herald_tpu_torch.sched.scheduler\n"
            "import herald_tpu_torch.sched.pysched\n"
            "import herald_tpu_torch.train.fae\n"
            "import herald_tpu_torch.data.loaders\n"
            "import herald_tpu_torch.data.prefetch\n"
            "import herald_tpu_torch.data.preprocess\n"
            "import herald_tpu_torch.onnx, herald_tpu_torch.onnx.proto\n"
            "import herald_tpu_torch.models.layers\n"
            "import herald_tpu_torch.models.initializers\n"
            "import herald_tpu_torch.utils.metrics\n"
            "import herald_tpu_torch.gnn, herald_tpu_torch.gnn.gcn\n"
            "import herald_tpu_torch.data.tokenizer\n"
            "import herald_tpu_torch.utils.hlo_stats\n"
            "import herald_tpu_torch.utils.graphboard\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'ml_dtypes', 'herald_tpu')\n"
            "       and sys.modules[m] is not None]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_engine_without_device_raises_when_no_card(monkeypatch):
    from herald_tpu_torch import Engine, HeraldConfig
    from herald_tpu_torch.launch import cli
    from herald_tpu_torch.serve import load_scorer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # the launcher raises before it loads data or builds anything
    args = cli.build_parser().parse_args(["--samples", "64", "--rows",
                                          "64"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.run_training(args)
    args = cli.build_parser().parse_args(["--scheduled", "--samples", "64",
                                          "--rows", "64"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.run_training(args)
    cfg = HeraldConfig(model="wdl_criteo", batch_size=4, embedding_dim=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, table_rows=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_scorer("/nonexistent", cfg, table_rows=64)
    from herald_tpu_torch.train.cached import CachedEngine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CachedEngine(cfg, table_rows=64)
    # an explicit device (argument or config field) is honoured
    assert Engine(cfg, table_rows=64, device="cpu").device.type == "cpu"
    cfg.device = "cpu"
    assert Engine(cfg, table_rows=64).device.type == "cpu"


def test_kernels_build_nothing_at_import():
    from herald_tpu_torch.ops.kernels import build
    before = set(build.BUILD_DIR.glob("*")) if build.BUILD_DIR.exists() \
        else set()
    code = "import herald_tpu_torch.serve, herald_tpu_torch.ops.kernels"
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   env={**os.environ, "PYTHONPATH": str(ROOT)}, timeout=120)
    after = set(build.BUILD_DIR.glob("*")) if build.BUILD_DIR.exists() \
        else set()
    assert after == before
