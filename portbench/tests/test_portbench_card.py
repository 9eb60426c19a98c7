"""On the card: one short run of a cell through the command, its result
line whole and correct."""

import json
import subprocess
import sys

import pytest
from conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("name", ["wdl_criteo.plain_stream"])
def test_cell_on_the_card(card, name):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         "2147483659", "--seconds", "2", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], out.stderr[-4000:]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
