"""One run of one cell: set-up, the measured window, the check.

Everything that belongs to one configuration, traffic mix or metric is
found by its name: ``configs/<config>.json`` (its ``format`` names the
workload module ``formats/<format>.py``), ``traffic/<traffic>.json`` (its
``generator`` names ``traffic/<generator>.py``) and
``metrics/<metric>.py``; the program's launch counters by their names
(``counters``).  ``BENCHMARK.json`` says which metrics a cell reports.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import pkgutil
import re
import shutil
import time
from pathlib import Path

from . import trace as trace_mod
from .spans import Spans

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root=ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError("no workload %r in BENCHMARK.json" % name)


def config(bench: dict, name: str, root=ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(Path(root) / c["file"])
    raise KeyError("no config %r in BENCHMARK.json" % name)


def traffic(name: str, bench_dir=BENCH) -> dict:
    return load_json(Path(bench_dir) / "traffic" / (name + ".json"))


def metrics(bench: dict, workload: dict, traced: bool) -> list:
    """The metrics a run of ``workload`` reports: its end-to-end metrics,
    or with ``traced`` its per-layer ones.  A metric's ``workloads`` names
    its cells; an end-to-end one without is reported everywhere, and
    every per-layer one has it."""
    name = workload["name"]
    if traced:
        return [m for m in bench["per_layer"] if name in m["workloads"]]
    return [m for m in bench["end_to_end"]
            if name in m.get("workloads", [name])]


def reader(name: str, bench_dir=BENCH):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = Path(bench_dir) / "metrics" / (name + ".py")
    spec_ = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod.read


def counters() -> dict:
    """The program's launch counters: every module-level int named
    ``*_LAUNCHES`` in the modules of ``minnow_torch.ops``, under its name,
    or ``K<n>`` for ``K<n>_LAUNCHES``.  A module that fails to import
    raises."""
    ops = importlib.import_module("minnow_torch.ops")
    out = {}
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(ops.__name__ + "." + info.name)
        for attr, value in vars(mod).items():
            if attr.endswith("_LAUNCHES") and type(value) is int:
                key = re.sub(r"^(K\d+)_LAUNCHES$", r"\1", attr)
                if key in out:
                    raise ValueError("two launch counters %s in %s"
                                     % (attr, ops.__name__))
                out[key] = value
    return out


class Run:
    """What the metric readers read: the window's requests and spans, the
    program's counters and stage times, the trace, and the kernels' bytes
    a request."""

    def __init__(self, records, start, end, spans, counts, stages,
                 trace, kernel_bytes, setup_s):
        self.records, self.start, self.end = records, start, end
        self.window_s = end - start
        self.spans, self.counters, self.stages = spans, counts, stages
        self.trace, self.kernel_bytes = trace, kernel_bytes
        self.setup_s = setup_s

    def done(self) -> int:
        return sum(1 for r in self.records if r["error"] is None)

    def values(self) -> int:
        return sum(r["values"] for r in self.records if r["error"] is None)

    def span_seconds(self, name: str) -> list:
        return self.spans.durations(name, self.start)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def inputs_made(device) -> None:
    """Called once set-up has made its inputs on ``device`` and before
    the program's first call: frees the blocks the inputs' making left
    cached and starts the card's memory peak afresh, so that
    ``memory_peak_bytes`` is the program's."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def run_cell(name: str, seed: int, seconds: float, traced: bool, device,
             t_start: float, root=ROOT, overrides=None, program=None,
             workdir=None):
    """Run cell ``name`` once: ``(result, checks, errors)``.  The result is
    the line ``run.py`` prints without its ``checks``; ``checks`` maps each
    number compared to ``[value, limit]``; ``errors`` are the failed
    requests' tracebacks.  ``overrides`` update the configuration (tests
    run small sizes); ``program`` replaces the window's outputs with its
    own (``program(workload, kept) -> kept``: the control, or a planted
    fault).  The run works in ``workdir``, by default
    ``build/benchmark/<cell>`` in the checkout, and empties it at the
    end."""
    import torch

    bench = spec(root)
    work = cell(bench, name)
    cfg = dict(config(bench, work["config"], root), **(overrides or {}))
    mix = traffic(work["traffic"], Path(root) / "benchmark")
    fmt = importlib.import_module("formats." + cfg["format"])
    gen = importlib.import_module("traffic." + mix["generator"])
    workdir = Path(workdir or Path(root) / "build" / "benchmark" / name)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    spans = Spans()
    on_card = torch.device(device).type == "cuda"
    try:
        wl = fmt.Workload(cfg, mix, seed, device, str(workdir), spans)
        wl.setup()
        sync(device)
        setup_s = time.perf_counter() - t_start
        before = counters()
        stages = getattr(wl, "timer", None)
        trace_path = str(workdir / "trace.json")
        ctx = (trace_mod.profile(trace_path) if traced
               else contextlib.nullcontext())
        spans.traced = traced
        with ctx:
            with spans.span(trace_mod.WINDOW):
                records, kept, start, end = gen.run(wl, seconds, mix, seed)
        spans.traced = False
        after = counters()
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        tr = trace_mod.Trace.load(trace_path) if traced else None
        wl.release()
        if program is not None:
            kept = program(wl, kept)
        kept = [(i, _host(out)) for i, out in kept]
        if on_card:
            torch.cuda.empty_cache()
        checks = wl.check(kept)
        del kept
        run = Run(records, start, end, spans,
                  {k: after[k] - before[k] for k in after},
                  {k: v["seconds"] for k, v in stages.report().items()}
                  if stages is not None else {},
                  tr, wl.kernel_bytes, setup_s)
        out = {}
        for m in metrics(bench, work, traced):
            value = reader(m["name"], Path(root) / "benchmark")(run)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        errors = [r["error"] for r in records if r["error"] is not None]
        correct = not errors and all(v <= lim for v, lim in checks.values())
        device_info = _device(device, peak, work["chips"])
        if tr is not None:
            device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result = {"correct": correct, "attempted": len(records),
                  "failed": len(errors), "metrics": out,
                  "device": device_info}
        if tr is not None:
            result["breakdown"] = tr.breakdown()
        return result, checks, errors
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _host(out):
    """A kept output as the check reads it: tensors come to the host."""
    import torch

    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return out


def _device(device, peak, chips) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak}

