"""A later change adds a configuration, a traffic mix, a metric or a file
format as new files and new entries alone: a temporary copy of the
benchmark with such an addition runs its new cell, reports the new
metric, and passes its own tests; the program's launch counters are found
by their names."""

import filecmp
import importlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from _paths import BENCH, ROOT

from harness import cell


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = cell.spec()
    b = root / "benchmark"
    cfg = cell.config(spec, "minh_L250")
    cfg["rows"] = 1200
    (b / "configs" / "minh_small.json").write_text(json.dumps(cfg))
    mix = dict(cell.traffic("read"), callers=2)
    (b / "traffic" / "read_2callers.json").write_text(json.dumps(mix))
    (b / "metrics" / "requests_a_second.py").write_text(
        "def read(run):\n    return run.done() / run.window_s\n")
    spec["configs"].append({"name": "minh_small", "source": "a test",
                            "file": "benchmark/configs/minh_small.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "minh_small.read_2callers",
                              "config": "minh_small",
                              "traffic": "read_2callers", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "minp_L250.read" in m["workloads"]:
            m["workloads"].append("minh_small.read_2callers")
    spec["end_to_end"].append({"name": "requests_a_second", "unit": "1/s",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["minh_small.read_2callers"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    result, checks, errors = cell.run_cell(
        "minh_small.read_2callers", 3, 0.3, False, "cpu", 0.0, root)
    assert result["correct"] and not errors, checks
    assert set(result["metrics"]) == {"read_rate", "setup_s",
                                      "requests_a_second"}
    assert result["metrics"]["requests_a_second"]["value"] > 0
    # the run worked inside the copy
    assert (root / "build" / "benchmark").is_dir()
    assert not os.path.exists(os.path.join(ROOT, "build", "benchmark",
                                           "minh_small.read_2callers"))


NEW_FORMAT = {"formats/minh_copy.py", "configs/minh_copy.json"}


def test_new_format_is_new_files_alone(tmp_path):
    """A format added as ``formats/minh_copy.py`` (``formats/minh.py``'s
    text), a configuration of it and a convert cell on it: the copy's
    correctness and manifest tests pass, the new cell's sound run, control
    and faults among them, with no file of the benchmark changed."""
    root = tmp_path / "checkout"
    b = root / "benchmark"
    shutil.copytree(BENCH, b, ignore=shutil.ignore_patterns("__pycache__"))
    spec = cell.spec()
    shutil.copyfile(b / "formats" / "minh.py", b / "formats" / "minh_copy.py")
    cfg = dict(cell.config(spec, "minh_L250"), format="minh_copy")
    (b / "configs" / "minh_copy.json").write_text(json.dumps(cfg))
    entry = next(c for c in spec["configs"] if c["name"] == "minh_L250")
    spec["configs"].append(dict(entry, name="minh_copy",
                                file="benchmark/configs/minh_copy.json"))
    spec["workloads"].append({"name": "minh_copy.convert",
                              "config": "minh_copy", "traffic": "convert",
                              "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "minh_L250.convert" in m.get("workloads", []):
            m["workloads"].append("minh_copy.convert")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    copied = {str(p.relative_to(b)) for p in b.rglob("*") if p.is_file()}
    kept = {str(p.relative_to(BENCH)) for p in Path(BENCH).rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}
    assert copied == kept | NEW_FORMAT and not kept & NEW_FORMAT
    for rel in kept:
        assert filecmp.cmp(b / rel, Path(BENCH) / rel, shallow=False), rel

    env = dict(os.environ, PYTHONPATH=ROOT)  # the program, not the copy
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider",
         "--basetemp", str(tmp_path / "inner"),
         "benchmark/tests/test_benchmark_correct.py",
         "benchmark/tests/test_benchmark_manifest.py"],
        capture_output=True, text=True, timeout=600, cwd=root, env=env)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    passed = {line.split("::", 1)[1] for line in out.stdout.splitlines()
              if line.startswith("PASSED ")}
    new = {"test_sound_run_is_correct[minh_copy.convert]",
           "test_control_is_not_correct[minh_copy.convert]"} | {
        "test_fault_is_not_correct[minh_copy.convert-%s]" % f
        for f in ("altered", "half", "unchanged")}
    assert new <= passed, sorted(passed)
    assert "test_pieces_found_by_name" in passed


def test_launch_counters_found_by_name(monkeypatch):
    from minnow_torch.ops import decode, encode, rebin

    named = {"K1": (encode, "K1_LAUNCHES"), "K3": (encode, "K3_LAUNCHES"),
             "K5": (encode, "K5_LAUNCHES"), "K2": (decode, "K2_LAUNCHES"),
             "K4": (decode, "K4_LAUNCHES"),
             "REBIN_LAUNCHES": (rebin, "REBIN_LAUNCHES")}
    before = cell.counters()
    for key, (mod, attr) in named.items():
        assert before[key] == getattr(mod, attr), key
    monkeypatch.setattr(rebin, "REBIN_LAUNCHES", rebin.REBIN_LAUNCHES + 3)
    # a later kernel's counter, in a module that is there
    monkeypatch.setattr(decode, "K9_LAUNCHES", 5, raising=False)
    after = cell.counters()
    assert after["REBIN_LAUNCHES"] == before["REBIN_LAUNCHES"] + 3
    assert after["K9"] == 5
    assert {k: after[k] for k in before if k != "REBIN_LAUNCHES"} == {
        k: v for k, v in before.items() if k != "REBIN_LAUNCHES"}


def test_a_counter_module_that_fails_to_import_raises(monkeypatch):
    real = importlib.import_module

    def import_module(name, *args):
        if name == "minnow_torch.ops.rebin":
            raise ImportError("a broken module")
        return real(name, *args)
    monkeypatch.setattr(cell.importlib, "import_module", import_module)
    with pytest.raises(ImportError):
        cell.counters()
