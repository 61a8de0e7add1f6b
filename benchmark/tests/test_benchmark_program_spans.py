"""The readers of the program's spans and counter, on a hand-built run and
hand-built records: nothing to read, or a ring that dropped records in
the window, reads None; records from before the window are left out;
otherwise the named spans' time (or the counter) is summed and divided
by the requests done."""

import pytest

from _paths import BENCH  # noqa: F401  (the benchmark on sys.path)

from harness import cell
from harness.spans import Spans
from minnow_torch.utils import profiling

# metric: the spans it sums (None: the fault counter of ``read.columns``)
READERS = {
    "snapshot_read_ms": ("lgadget2.read",),
    "rebin_ms": ("grid.cell_index", "grid.scatter", "minp.split_sub_cells"),
    "encode_ms": ("encoder.encode_float", "encoder.encode_int"),
    "file_write_ms": ("container.write", "container.close"),
    "read_file_ms": ("read.tail", "read.span"),
    "read_stage_ms": ("read.stage",),
    "read_copy_ms": ("read.copy",),
    "read_faults": None,
}


def make_run(start=100.0, end=200.0, done=2):
    requests = [{"i": i, "start": start, "end": end, "values": 1,
                 "error": None} for i in range(done)]
    requests.append({"i": done, "start": start, "end": end, "values": 0,
                     "error": "a failed request"})
    return cell.Run(requests, start, end, Spans(), {}, {}, None, {}, 1.0)


def rec(name, start, seconds, faults=None):
    s = profiling.span(name)
    s.start, s.end = start, start + seconds
    if faults is not None:
        s.counts["minor_faults"] = faults
    return s


@pytest.fixture
def ring(monkeypatch):
    r = profiling.Ring(64)
    monkeypatch.setattr(profiling, "RING", r)
    return r


def add_window(ring, spans):
    """Records of ``spans`` (or of ``read.columns``) in the window and
    before it, and of another name; what a reader should read from
    them with 2 requests done."""
    names = spans or ("read.columns",)
    for k, name in enumerate(names):
        ring.add(rec(name, 99.0, 5.0, faults=1000))  # before the window
        ring.add(rec(name, 120.0 + k, 0.25, faults=300 + k))
        ring.add(rec(name, 150.0 + k, 0.5, faults=500))
        ring.add(rec(name, 201.0, 0.5, faults=900))  # after its end
    ring.add(rec("elsewhere", 130.0, 9.0, faults=7000))
    if spans is None:
        return (800 * len(names) + sum(range(len(names)))) / 2
    return 0.75 * len(names) / 2 * 1e3


@pytest.mark.parametrize("name", sorted(READERS))
def test_nothing_to_read_is_none(ring, name):
    assert cell.reader(name)(make_run()) is None
    add_window(ring, READERS[name])
    assert cell.reader(name)(make_run(done=0)) is None
    ring.add(rec("elsewhere", 300.0, 1.0))
    assert cell.reader(name)(make_run(start=250.0, end=350.0)) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_drop_in_the_window_is_none(monkeypatch, name):
    small = profiling.Ring(3)
    monkeypatch.setattr(profiling, "RING", small)
    add_window(small, READERS[name])
    assert cell.reader(name)(make_run()) is None
    # a drop before the window leaves the window whole
    for t in (260.0, 261.0, 262.0):
        small.add(rec((READERS[name] or ("read.columns",))[0], t, 0.5,
                      faults=10))
    assert cell.reader(name)(make_run(start=250.0, end=300.0)) is not None


@pytest.mark.parametrize("name", sorted(READERS))
def test_the_sum_a_request(ring, name):
    want = add_window(ring, READERS[name])
    assert cell.reader(name)(make_run()) == pytest.approx(want)


def test_a_counter_without_its_count_is_none(ring):
    ring.add(rec("read.columns", 120.0, 0.25))
    assert cell.reader("read_faults")(make_run()) is None
