"""A later change adds a configuration, a traffic mix and a metric as new
files and new entries alone: a temporary copy of the benchmark with such
an addition runs its new cell, and reports the new metric."""

import json
import os
import shutil

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
