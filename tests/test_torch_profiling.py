"""The port's spans (``minnow_torch.utils.profiling``): parents and roots on
one thread and across the text prefetch's hand-off, the bounded ring and
its report of a drop, ``record_function`` ranges only under a profiler,
the benchmark's trace naming an idle gap by the innermost program span,
``StageTimer`` fed by the same spans, and the spans each entry point of
the benchmark's cells opens, on the CPU."""

import collections
import importlib.util
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from minnow_torch.cli import convert_snapshot, text_to_minh
from minnow_torch.formats import minp, minp_device
from minnow_torch.ingest import lgadget2, snapshot
from minnow_torch.utils import profiling
from minnow_torch.utils.name_index import open_index
from test_torch_text_to_minh import write_catalog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trace_module():
    """``benchmark/harness/trace.py``, the benchmark's reduction of a
    profiler trace, loaded by its path."""
    path = os.path.join(REPO, "benchmark", "harness", "trace.py")
    spec = importlib.util.spec_from_file_location("bench_trace", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _named(since, prefix):
    spans, dropped = profiling.records(since)
    assert not dropped
    return [s for s in spans if s.name.startswith(prefix)]


def test_spans_nest_on_one_thread_and_share_their_root():
    t0 = time.perf_counter()
    with profiling.span("t.call") as call:
        with profiling.span("t.step", 7) as step:
            with profiling.span("t.inner") as inner:
                pass
        with profiling.span("t.other") as other:
            pass
    with profiling.span("t.next") as nxt:
        pass
    assert [s.name for s in _named(t0, "t.")] == [
        "t.inner", "t.step", "t.other", "t.call", "t.next"]
    assert call.parent is None and call.root == call.id
    assert (step.parent, inner.parent, other.parent) == (
        call.id, step.id, call.id)
    assert {step.root, inner.root, other.root} == {call.id}
    assert nxt.parent is None and nxt.root == nxt.id != call.id
    assert call.start <= step.start <= inner.start <= inner.end \
        <= step.end <= other.start <= other.end <= call.end <= nxt.start
    assert step.nbytes == 7 and call.nbytes == 0
    assert {s.thread for s in (call, step, inner, nxt)} == {
        threading.get_ident()}


def test_a_worker_span_has_the_submitter_as_parent():
    def work():
        with profiling.span("t.work") as w:
            return w

    t0 = time.perf_counter()
    with profiling.span("t.submit") as sub:
        with ThreadPoolExecutor(max_workers=1) as pool:
            carried = pool.submit(profiling.carry(work)).result()
            # unwrapped, the worker's span is a root of its own; the
            # carried call left no span behind on the worker's stack
            alone = pool.submit(work).result()
    assert carried.parent == sub.id and carried.root == sub.id
    assert carried.thread != sub.thread
    assert alone.parent is None and alone.root == alone.id
    assert {s.name for s in _named(t0, "t.")} == {"t.work", "t.submit"}


def test_the_ring_is_bounded_and_reports_a_drop(monkeypatch):
    monkeypatch.setattr(profiling, "RING", profiling.Ring(4))
    t0 = time.perf_counter()
    spans = []
    for i in range(3):
        with profiling.span("t.%d" % i) as s:
            spans.append(s)
    got, dropped = profiling.records(t0)
    assert got == spans and not dropped
    for i in range(3, 6):
        with profiling.span("t.%d" % i) as s:
            spans.append(s)
    got, dropped = profiling.records(t0)
    assert got == spans[2:] and dropped
    # the drop lies before these starts: nothing of theirs was lost
    assert profiling.records(spans[2].start) == (spans[2:], False)
    assert profiling.records(spans[5].end + 1) == ([], False)


def test_a_range_only_under_a_profiler(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def spy(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with profiling.span("t.quiet"):
        pass
    assert made == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("t.loud"):
            pass
    assert made == ["t.loud"]


def _profiled(tmp_path, body):
    """Run ``body`` in a ``window`` range under a CPU profile; the trace
    as the benchmark reduces it, and its annotations' names."""
    path = str(tmp_path / "trace.json")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("window"):
            body()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"}
    return _trace_module().Trace.load(path), names


def test_the_trace_names_the_gap_by_the_innermost_program_span(tmp_path):
    def body():
        with profiling.span("t_mod.call"):
            time.sleep(0.01)
            with profiling.span("t_mod.step"):
                time.sleep(0.1)
            time.sleep(0.01)

    trace, names = _profiled(tmp_path, body)
    assert {"window", "t_mod.call", "t_mod.step"} <= names
    assert trace.busy_s == 0
    assert trace.gaps[0][0] == "t_mod.step"


def test_the_main_threads_wait_names_the_gap_of_a_worker(tmp_path):
    held = []

    def work():
        with profiling.span("t_mod.work") as w:
            time.sleep(0.1)
            held.append(w)

    t0 = time.perf_counter()

    def body():
        with profiling.span("t_mod.call") as call:
            held.append(call)
            with ThreadPoolExecutor(max_workers=1) as pool:
                fut = pool.submit(profiling.carry(work))
                with profiling.span("t_mod.wait"):
                    fut.result()

    trace, names = _profiled(tmp_path, body)
    call, worker = held
    assert worker.parent == call.id and worker.root == call.id
    assert worker in _named(t0, "t_mod.")
    assert trace.gaps[0][0] == "t_mod.wait"


def test_stage_timer_is_fed_by_the_same_span():
    timer = profiling.StageTimer()
    with timer.stage("pack", "t.pack", nbytes=10) as sp:
        time.sleep(0.001)
    with profiling.span("t.unit", 5, timer, "pack") as sp2:
        pass
    seconds, nbytes = timer.stages["pack"]
    assert seconds == pytest.approx((sp.end - sp.start)
                                    + (sp2.end - sp2.start), abs=1e-12)
    assert nbytes == 15 and sp.name == "t.pack"


def _args(config):
    cfg = text_to_minh.parse_config(str(config))
    idx = open_index(cfg["NameIndex"])
    return (cfg, idx, text_to_minh.parse_types(cfg["TypeIndex"], idx),
            text_to_minh.parse_vars("all", idx))


def test_convert_file_spans_and_stage_keys(tmp_path):
    config, hlist = write_catalog(tmp_path)
    timer = profiling.StageTimer()
    t0 = time.perf_counter()
    text_to_minh.convert_file(*_args(config), str(hlist),
                              str(tmp_path / "out.minh"), "cpu",
                              timer=timer)
    assert set(timer.report()) == {"read", "scan_lines", "parse",
                                   "mass_cut", "encode+write"}
    spans, dropped = profiling.records(t0)
    assert not dropped
    assert collections.Counter(s.name for s in spans) == {
        "text_to_minh.convert_file": 1, "text.read": 1,
        "text.scan_lines": 1, "text.parse": 1,
        "text_to_minh.parse_wait": 1, "text_to_minh.mass_cut": 1,
        "text_to_minh.encode_write": 1, "encoder.encode_float": 1,
        "encoder.encode_int": 1, "encoder.payloads": 2,
        "container.write": 1, "container.close": 1}
    by = {s.name: s for s in spans}
    root = by["text_to_minh.convert_file"]
    assert {s.root for s in spans} == {root.id}
    # the parse ran on the prefetch thread, under the call
    assert by["text.parse"].thread != root.thread
    assert by["text.read"].parent == root.id
    assert by["container.write"].parent == by["text_to_minh.encode_write"].id
    for name, key in (("text.parse", "parse"), ("text_to_minh.mass_cut",
                                                "mass_cut")):
        s = by[name]
        assert timer.stages[key][0] == pytest.approx(s.end - s.start,
                                                     abs=1e-12)
    assert timer.stages["read"][1] == os.path.getsize(hlist)


def write_gadget(d, n_side=8, files=2, l=50.0, seed=5):
    """An LGadget-2 fileset of ``files`` files, the particles' ids
    shuffled across them."""
    rng = np.random.default_rng(seed)
    n = n_side ** 3
    hd = minp.Header(z=0.0, scale=1.0, omega_m=0.3, omega_l=0.7, h100=0.7,
                     l=l, n_side=n_side, n_total=n)
    snapshot.calc_uniform_mass(hd)
    parts = np.array_split(np.arange(n), files)
    ids = rng.permutation(n) + 1
    x = rng.uniform(0, l * 0.99, (n, 3)).astype(np.float32)
    v = rng.normal(0, 50, (n, 3)).astype(np.float32)
    snap = snapshot.MockSnapshot(hd, [x[p] for p in parts],
                                 [v[p] for p in parts],
                                 [ids[p] for p in parts])
    os.makedirs(d)
    gh = lgadget2.LGadget2Header(time=1.0, box_size=l, omega0=0.3,
                                 omega_lambda=0.7, hubble_param=0.7,
                                 n_part_total=(0, n, 0, 0, 0, 0))
    lgadget2.write_lgadget2(d, "snap_%03d.dat", snap, gh)
    return d


def test_to_minp_and_read_vectors_open_their_spans(tmp_path):
    gdir = write_gadget(str(tmp_path / "g"))
    out = tmp_path / "out"
    out.mkdir()
    t0 = time.perf_counter()
    convert_snapshot.to_minp(gdir, str(out), 1, 2, 0.001, 0.01, "cpu")
    spans, dropped = profiling.records(t0)
    assert not dropped
    # one batch of the one cell: two input files, each read for its
    # positions, velocities and ids, its ids and vectors copied and
    # scattered once; one output file a kind, three axes of blocks
    assert collections.Counter(s.name for s in spans) == {
        "convert_snapshot.to_minp": 1, "lgadget2.read": 6,
        "grid.cell_index": 2, "grid.scatter": 2,
        "minp.split_sub_cells": 2, "encoder.encode_float": 6,
        "encoder.payloads": 6, "container.write": 6, "container.close": 2}
    root = next(s for s in spans if s.name == "convert_snapshot.to_minp")
    assert {s.root for s in spans} == {root.id}
    # the spans rebin_ms reads, from the device route (the plain version
    # of csrc/rebin.cu on the CPU)
    assert all(s.counts == {"device": 1} for s in spans
               if s.name == "grid.scatter")

    allocs = []
    for name in ("x_0.minp", "v_0.minp"):
        with minp.open(str(out / name)) as r:
            t1 = time.perf_counter()
            got = minp_device.read_vectors(r, "cpu")
            spans, dropped = profiling.records(t1)
            want = r.vectors()
        np.testing.assert_array_equal(got.numpy(), want)
        assert not dropped
        assert collections.Counter(s.name for s in spans) == {
            "minp_device.read_vectors": 1, "read.columns": 1,
            "read.tail": 1, "read.span": 1, "read.stage": 1,
            "read.copy": 1}
        by = {s.name: s for s in spans}
        assert by["read.columns"].counts["minor_faults"] >= 0
        # the staged words hold the span read and the tables
        assert 0 < by["read.span"].nbytes < by["read.copy"].nbytes
        assert by["read.stage"].end <= by["read.copy"].start
        # the tables are staged first, then the span is read in after them
        assert by["read.stage"].end <= by["read.span"].start
        assert by["read.copy"].parent == by["read.columns"].id
        # the staged words and tables in the reused staging buffer: the
        # copy is its used prefix, pageable on the CPU
        assert by["read.stage"].counts.keys() == {"staging_allocs",
                                                  "pinned"}
        assert by["read.stage"].counts["pinned"] == 0
        allocs.append(by["read.stage"].counts["staging_allocs"])
    # x_0's read left a buffer that v_0's span and tables fit
    assert allocs[0] in (0, 1) and allocs[1] == 0
