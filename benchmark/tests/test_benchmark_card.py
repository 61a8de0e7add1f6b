"""Each cell once on the card, as the benchmark's command runs it, for a
few seconds: the result line is whole and correct.  Needs a CUDA card and
skips without one; run on the card from the checkout's root with

    python -m pytest -m cuda benchmark/tests -q
"""

import json
import os
import subprocess
import sys

import pytest

from _paths import BENCH, ROOT

from harness import cell

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in cell.spec()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name, traced):
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload", name,
         "--seed", str(2 ** 31 + 11), "--seconds", "2", "--trace",
         str(traced)], capture_output=True, text=True, timeout=600,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu"
    names = {m["name"] for m in cell.metrics(
        cell.spec(), cell.cell(cell.spec(), name), bool(traced))}
    assert set(result["metrics"]) <= names
    if traced:
        assert result["device"]["busy_s"] > 0
    else:
        assert set(result["metrics"]) == names
