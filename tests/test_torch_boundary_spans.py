"""The spans of the port's ``minh_to_bnd.convert_file`` on the CPU: the call
is the root; the boundary cell assignment is one ``boundary.cells`` span
with its halos, rows and cells counted; each coded column is one
``boundary.gather``, and each column, the flag column inside
``boundary.cells`` included, one ``container.write``; no span opens
inside a loop over cells, so the spans are the same at any number of
cells."""

import collections
import time

import pytest

from minnow_torch.cli import minh_to_bnd
from minnow_torch.formats import minh
from minnow_torch.utils import profiling
from test_torch_minh_to_bnd import write_catalog

BND = 5.0
# 7 coded columns (id, pid: Int; x, y, z, mvir, vx: Float), x, y and z
# read twice: for the cell assignment and as columns
READS = 10
CODED = 7
# the raw columns (upid: int64; weird: float32), written by the host
RAW = 2


@pytest.fixture
def src(tmp_path):
    return write_catalog(tmp_path)


def _convert(src, out, cells, device):
    t0 = time.perf_counter()
    minh_to_bnd.convert_file(str(src), str(out), cells, BND, device)
    spans, dropped = profiling.records(t0)
    assert not dropped
    return spans


@pytest.mark.parametrize("cells", [2, 4, 5])
def test_convert_file_spans(src, tmp_path, cells):
    out = tmp_path / "out.bnd.minh"
    spans = _convert(src, out, cells, "cpu")
    reads = {"read.columns": READS, "read.tail": READS, "read.span": READS,
             "read.stage": READS, "read.copy": READS}
    assert collections.Counter(s.name for s in spans) == dict(
        reads, **{"minh_to_bnd.convert_file": 1, "boundary.cells": 1,
                  "boundary.gather": CODED, "encoder.encode_int": 2,
                  "encoder.encode_float": 5, "encoder.payloads": CODED,
                  "container.write": 1 + CODED + RAW,
                  "container.close": 1})
    root = next(s for s in spans if s.name == "minh_to_bnd.convert_file")
    assert {s.root for s in spans} == {root.id}
    cells_span = next(s for s in spans if s.name == "boundary.cells")
    for s in spans:
        if s.name in ("boundary.cells", "boundary.gather"):
            assert s.parent == root.id, s.name
    writes = [s.parent for s in spans if s.name == "container.write"]
    assert sorted(writes) == sorted([cells_span.id]
                                    + [root.id] * (CODED + RAW))

    with minh.open(str(src)) as r:
        halos = r.length
    with minh.open(str(out)) as r:
        lengths = r.block_lengths
    assert cells_span.counts == {"halos": halos, "rows": sum(lengths),
                                 "cells": cells ** 3}
    assert sum(lengths) > halos  # ghosts were written
    for s in spans:
        if s.name == "boundary.gather":
            assert s.counts == {"nmax": max(lengths), "rows": sum(lengths)}


def test_host_mode_opens_the_cell_span_and_the_writes(src, tmp_path):
    spans = _convert(src, tmp_path / "out.bnd.minh", 4, None)
    names = collections.Counter(s.name for s in spans)
    assert names["minh_to_bnd.convert_file"] == 1
    assert names["boundary.cells"] == 1
    assert names["container.write"] == 1 + CODED + RAW
    assert not {"boundary.gather", "read.columns"} & set(names)


def test_every_group_lies_in_a_write_span(src, tmp_path, monkeypatch):
    """Every group the container starts, the flag column's and the raw
    columns' too, starts inside a ``container.write`` span."""
    from minnow_torch.core import writer

    starts = []

    def spy(real):
        def group(self, *args, **kw):
            starts.append(time.perf_counter())
            return real(self, *args, **kw)
        return group

    for name in ("int_group", "float_group", "fixed_size_group"):
        monkeypatch.setattr(writer.Writer, name,
                            spy(getattr(writer.Writer, name)))
    spans = _convert(src, tmp_path / "out.bnd.minh", 4, "cpu")
    writes = [(s.start, s.end) for s in spans if s.name == "container.write"]
    assert len(starts) == 4 ** 3 * (1 + CODED + RAW)
    assert all(any(a <= t <= b for a, b in writes) for t in starts)
