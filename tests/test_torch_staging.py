"""The bulk read's staging buffer (``formats/device_common.py``) on the
CPU: one buffer a thread, reused from call to call, grown where a span and
its tables do not fit and never shrunk; every result bitwise the host
reader's, none a view of the buffer, and the padding after a span zero
whatever an earlier, longer span left there.
"""

import sys
import threading
import time

import numpy as np
import pytest

from minnow_torch.core import spec
from minnow_torch.formats import device_common, minp, minp_device
from minnow_torch.ops import decode
from minnow_torch.utils import profiling


def _write(fname, n_side, seed):
    """A periodic minp file of ``n_side``^3 particles in 2^3 sub-cells."""
    rng = np.random.default_rng(seed)
    hd = minp.Header(l=100.0, n_side=n_side, n_total=n_side ** 3)
    w = minp.Writer(fname)
    w.header(hd, b"h", minp.Cell(0, 1, 2), 0.01, True)
    w.vectors(rng.uniform(0, 99.9, (n_side ** 3, 3)).astype(np.float32))
    w.close()
    return fname


def _read(fname):
    """``(got, want, stage)``: ``read_vectors`` of ``fname`` on the CPU as
    float32 bits, ``reader.vectors()``'s bits, and the call's one
    ``read.stage`` span on this thread."""
    me = threading.get_ident()
    with minp.open(fname, dither="uniform", seed=7) as r:
        t0 = time.perf_counter()
        got = minp_device.read_vectors(r, "cpu").numpy()
        spans, dropped = profiling.records(t0)
        want = r.vectors()
    assert not dropped
    (stage,) = [s for s in spans if s.name == "read.stage"
                and s.thread == me]
    return got.view(np.uint32), want.view(np.uint32), stage


@pytest.fixture
def files(tmp_path):
    """A small file, and a large one of more than 1.25 times its span."""
    return (_write(str(tmp_path / "small.minp"), 8, 1),
            _write(str(tmp_path / "large.minp"), 16, 2))


def test_reads_of_other_sizes_reuse_one_buffer(files):
    """Large, small, small: bitwise each time, and the second read of the
    small file allocates nothing."""
    small, large = files
    counts = []
    for fname in (large, small, small):
        got, want, stage = _read(fname)
        np.testing.assert_array_equal(got, want)
        counts.append(stage.counts)
    assert counts[2] == {"staging_allocs": 0, "pinned": 0}
    assert counts[1]["staging_allocs"] == 0  # the large file's buffer


def test_buffer_grows_once_and_never_shrinks():
    """A fresh thread's buffer: allocated by its first stage, grown by a
    span more than a quarter larger than it holds, and then kept for the
    smaller spans and for one a little larger than the first large."""
    rng = np.random.default_rng(8)
    # about 0.3, 2.7 and 2.8 MB: more than the buffer's first MiB
    spans = {n: _span(rng, n) for n in (50000, 400000, 410000)}
    allocs, errors = [], []

    def run():
        try:
            for n in (50000, 50000, 400000, 50000, 410000, 400000):
                span, col = spans[n]
                t0 = time.perf_counter()
                src, (s,) = device_common.stage_columns(span, [col], "cpu")
                (stage,) = [x for x in profiling.records(t0)[0]
                            if x.name == "read.stage"
                            and x.thread == threading.get_ident()]
                allocs.append(stage.counts["staging_allocs"])
                np.testing.assert_array_equal(
                    decode.decode_int_ragged(src, s.table).numpy(),
                    np.concatenate(_spec_ints(span, col)))
        except Exception as e:  # reported by the main thread
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and not errors, errors
    assert allocs == [1, 0, 1, 0, 0, 0]


def test_a_result_is_no_view_of_the_buffer(files):
    """A result, and the words a stage hands on, stay as they were after
    later reads and stages reuse the buffer."""
    small, large = files
    first, want, _ = _read(small)
    kept = first.copy()
    for fname in (large, small):
        _read(fname)
    np.testing.assert_array_equal(first, kept)
    np.testing.assert_array_equal(first, want)

    span, col = _span(np.random.default_rng(3), 4001)
    src, (s,) = device_common.stage_columns(span, [col], "cpu")
    words = src.numpy().copy()
    device_common.stage_columns(np.full(span.size, 0xFF, np.uint8), [col],
                                "cpu")
    np.testing.assert_array_equal(src.numpy(), words)
    np.testing.assert_array_equal(
        decode.decode_int_ragged(src, s.table).numpy(),
        np.concatenate(_spec_ints(span, col)))


def test_two_threads_read_at_once(files):
    """Two threads, each reading its own file in a loop, at a short
    switch interval: every result bitwise the host reader's, and each
    thread's first read allocates a buffer of its own."""
    wants = {f: _read(f)[1] for f in files}
    errors, done = [], []

    def run(fname):
        try:
            for i in range(6):
                got, _, stage = _read(fname)
                np.testing.assert_array_equal(got, wants[fname])
                assert stage.counts["staging_allocs"] == (i == 0)
            done.append(fname)
        except Exception as e:  # reported by the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(f,)) for f in files]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert sorted(done) == sorted(files)


def _span(rng, n):
    """A span of int blocks of widths 7, 13 and 33 (``n`` values each),
    back to back from byte 1, and its column."""
    bits = np.array([7, 13, 33], np.int64)
    payloads = [spec.pack_bits(rng.integers(0, 1 << int(b), n,
                                            dtype=np.uint64), int(b))
                for b in bits]
    start = np.cumsum([1] + [len(p) for p in payloads[:-1]])
    span = np.frombuffer(b"\x05" + b"".join(payloads), np.uint8)
    col = device_common.Blocks(start.astype(np.int64), bits,
                               np.full(3, n, np.int64),
                               np.array([-4, 0, 1 << 40], np.int64), None,
                               np.arange(3, dtype=np.int64))
    return span, col


def _spec_ints(span, col):
    return [spec.decode_int_block(span[a:a + m].tobytes(), int(mn), int(b),
                                  int(n))
            for a, m, mn, b, n in zip(col.start, col.nbytes, col.mins,
                                      col.bits, col.lens)]


@pytest.mark.parametrize("n", [4001, 4002, 4003, 4011])
def test_padding_after_a_shorter_span_is_zero(n):
    """A long span of 0xFF bytes staged first, then a span whose length
    is 1, 0, 2 or 3 mod 4: its words are the span padded with zeros to
    whole words and 8 bytes more, as a fresh zeroed buffer gives, and
    decode to the host codec's values."""
    rng = np.random.default_rng(n)
    long_span, long_col = _span(rng, 3 * n)
    device_common.stage_columns(np.full(long_span.size, 0xFF, np.uint8),
                                [long_col], "cpu")
    span, col = _span(rng, n)
    src, (s,) = device_common.stage_columns(span, [col], "cpu")
    want = np.zeros(-(-span.size // 4) + 2, np.int32)
    want.view(np.uint8)[:span.size] = span
    np.testing.assert_array_equal(src.numpy(), want)
    np.testing.assert_array_equal(
        decode.decode_int_ragged(src, s.table).numpy(),
        np.concatenate(_spec_ints(span, col)))
