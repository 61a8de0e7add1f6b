"""``BENCHMARK.json`` against the benchmark's contract, and every piece it
names found by its name; nothing the benchmark runs loads jax, jaxlib,
flax or minnow_tpu."""

import importlib
import json
import os
import re
import subprocess
import sys

import pytest

from _paths import BENCH, ROOT

from harness import cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")

SPEC = cell.spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def _line(text):
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def test_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in SPEC["per_layer"]:
        # every per-layer metric names its cells: the harness reports it
        # in those and no others
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_names_and_units():
    names = ([m["name"] for m in METRICS] + CELLS
             + [c["name"] for c in SPEC["configs"]]
             + [w["config"] for w in SPEC["workloads"]]
             + [w["traffic"] for w in SPEC["workloads"]]
             + [k for c in SPEC["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.match(n), n
    for group in (METRICS, SPEC["workloads"], SPEC["configs"]):
        assert len({x["name"] for x in group}) == len(group)
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in SPEC["configs"]]
                 + [c["source"] for c in SPEC["configs"]]
                 + [w["why"] for w in SPEC["workloads"]]
                 + [m["layer"] for m in SPEC["per_layer"]]
                 + SPEC["command"]):
        assert _line(text), text


def test_command_and_paths():
    assert 1 <= len(SPEC["paths"]) <= 16
    assert len(SPEC["command"]) <= 32
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.rstrip("/").endswith("_torch")
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word
        if os.path.exists(os.path.join(ROOT, word)):
            assert any(word.startswith(p.rstrip("/") + "/")
                       for p in SPEC["paths"]), word


def test_sizes_and_bounds():
    assert 1 <= len(SPEC["configs"]) <= 24
    assert 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    assert 1 <= len(SPEC["per_layer"]) <= 128
    seconds = SPEC["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51
    assert (2 + 14 * 24) * (seconds + 60) + 24 * 180 + 1200 <= 43200
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_pieces_found_by_name():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/")
        assert c["file"] == "benchmark/configs/%s.json" % c["name"]
        cfg = cell.config(SPEC, c["name"])
        fmt = importlib.import_module("formats." + cfg["format"])
        for piece in ("Workload", "small", "faults"):
            assert callable(getattr(fmt, piece, None)), \
                "formats/%s.py has no %s" % (cfg["format"], piece)
        assert isinstance(fmt.small(cfg), dict), cfg["format"]
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(SPEC["workloads"])
    for w in SPEC["workloads"]:
        mix = cell.traffic(w["traffic"])
        importlib.import_module("traffic." + mix["generator"]).run
        assert mix["kind"] in ("read", "convert")
        name = cell.config(SPEC, w["config"])["format"]
        try:
            planted = importlib.import_module("formats." + name).faults(
                mix["kind"])
        except KeyError:
            pytest.fail("formats/%s.py plants no faults for %s traffic (%s)"
                        % (name, mix["kind"], w["name"]))
        assert planted, (name, mix["kind"])
    for m in METRICS:
        assert callable(cell.reader(m["name"]))


def test_every_cell_reports_enough():
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in cell.metrics(SPEC, w, False)}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.metrics(SPEC, w, True), w["name"]


def test_per_layer_cells_report_what_they_move():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        reporting = set(moved.get("workloads", CELLS))
        assert set(m["workloads"]) <= reporting, m["name"]
        assert set(m["workloads"]) <= set(CELLS)
        layers.setdefault(m["layer"], []).append(m["name"])
    assert "kernels" in layers and "device" in layers
    for m in SPEC["end_to_end"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_roofline_names():
    for m in METRICS:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and m["source"] == "device_trace"


IMPORT_CHECK = r"""
import importlib, pkgutil, runpy, sys
sys.path[:0] = [%(root)r, %(bench)r]
runpy.run_path(%(run)r, run_name="not_main")
from harness import cell
spec = cell.spec()
for c in spec["configs"]:
    importlib.import_module("formats." + cell.config(spec, c["name"])["format"])
for w in spec["workloads"]:
    importlib.import_module("traffic." + cell.traffic(w["traffic"])["generator"])
for m in spec["end_to_end"] + spec["per_layer"]:
    cell.reader(m["name"])
for pkg in ("harness", "reference", "traffic", "formats"):
    mod = importlib.import_module(pkg)
    for info in pkgutil.iter_modules(mod.__path__):
        importlib.import_module(pkg + "." + info.name)
import minnow_torch.ops.encode, minnow_torch.ops.decode
print(sorted({m.split(".")[0] for m in sys.modules}
             & {"jax", "jaxlib", "flax", "minnow_tpu"}))
"""


def test_nothing_loads_jax_or_the_jax_package():
    code = IMPORT_CHECK % {"root": ROOT, "bench": BENCH,
                           "run": os.path.join(BENCH, "run.py")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                          "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1"], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_configs_state_their_cuts():
    for c in SPEC["configs"]:
        cfg = cell.config(SPEC, c["name"])
        assert set(cfg["reduced"]) == set(c["reduced"])
        for key in c["reduced"]:
            assert key in cfg and not key.endswith(("_dim", "_rank"))
        assert cfg["assumed"]
        json.dumps(cfg)
