"""Streaming ASCII catalog reader (ref go/text/text.go, go/text/parse.go).

Giant text catalogs are processed in at most ``max_block_size`` chunks
split at newlines found within a ``max_item_size`` search window
(ref go/text/text.go:82-131), so memory stays bounded no matter the file
size.  Field parsing of the requested columns runs in the native C++
engine with a std::thread pool (minnow_torch/native.py) -- the counterpart
of the reference's goroutine ``thread.SplitArray`` fan-out
(ref go/text/parse.go:80-174, go/thread/thread.go).

The port's own copy of ``minnow_tpu/ingest/text.py``: the same
arithmetic and the same bytes, on numpy, with no import from that
package.
"""

from __future__ import annotations

from dataclasses import dataclass
import io

import numpy as np

from .. import native


@dataclass
class ReaderConfig:
    """(ref go/text/text.go:25-37)"""

    separator: bytes = b" "
    comment: bytes = b"#"
    max_block_size: int = 5 * (1 << 30)
    max_item_size: int = 100 * (1 << 10)


DEFAULT_READER_CONFIG = ReaderConfig()


class Reader:
    """Chunked text-catalog reader (ref go/text/text.go:11-231)."""

    def __init__(self, f, config: ReaderConfig = None, closer=None):
        self.config = config or DEFAULT_READER_CONFIG
        if self.config.max_block_size // 2 < self.config.max_item_size:
            raise ValueError(
                "config.max_block_size = %d, but config.max_item_size = %d"
                % (self.config.max_block_size, self.config.max_item_size))
        self.f = f
        self.closer = closer
        self.threads = 1
        self.timer = None
        self.names: list[str] | None = None
        # block() may be called for different blocks from prefetch
        # threads (cli/text_to_minh.py); the shared handle's seek+read
        # must not interleave
        import threading

        self._read_lock = threading.Lock()
        self._find_blocks(_reader_size(f))

    # -- block discovery (ref go/text/text.go:82-131) -----------------------

    def _find_blocks(self, size: int) -> None:
        self.f.seek(0)
        starts = []
        end = 0
        while end != -1:
            starts.append(end)
            end = self._next_block(size)
        self.block_starts = starts
        self.n_blocks = len(starts)
        self.block_sizes = [
            (starts[i + 1] if i + 1 < len(starts) else size) - starts[i]
            for i in range(len(starts))]

    def _next_block(self, size: int) -> int:
        curr = self.f.tell()
        if curr + self.config.max_block_size >= size:
            self.f.seek(0, io.SEEK_END)
            return -1
        search_start = curr + self.config.max_block_size \
            - self.config.max_item_size
        self.f.seek(search_start)
        buf = self.f.read(self.config.max_item_size)
        delta = buf.find(b"\n")
        if delta == -1:
            raise ValueError("config.max_item_size too small.")
        block_end = search_start + delta + 1
        self.f.seek(block_end)
        return block_end

    # -- headers (ref go/text/text.go:135-163) ------------------------------

    def _header_lines(self):
        self.f.seek(0)
        buf_size = min(_reader_size(self.f), self.config.max_item_size)
        buf = self.f.read(buf_size)
        lines = buf.split(b"\n")
        n_comm = sum(1 for ln in lines if ln.startswith(self.config.comment))
        return lines, n_comm

    def line_header(self, lines: int) -> str:
        hd_lines, _ = self._header_lines()
        if len(hd_lines) <= lines:
            raise ValueError("config.max_item_size too small.")
        return b"\n".join(hd_lines[:lines]).decode()

    def comment_header(self) -> str:
        hd_lines, n_comm = self._header_lines()
        if len(hd_lines) == n_comm:
            raise ValueError("config.max_item_size too small.")
        out = []
        for ln in hd_lines:
            if not ln.startswith(self.config.comment):
                break
            out.append(ln)
        return b"\n".join(out).decode()

    # -- API ---------------------------------------------------------------

    def set_names(self, names) -> None:
        self.names = [n.lower() for n in names]

    def set_threads(self, n: int) -> None:
        self.threads = n

    def set_timer(self, timer) -> None:
        """Attach a utils.profiling.StageTimer; block() then records
        read/scan/parse stage times (BASELINE.md per-stage GB/s)."""
        self.timer = timer

    def blocks(self) -> int:
        return self.n_blocks

    def _name_index(self, name: str) -> int:
        if self.names is None:
            raise RuntimeError(
                "Must call Reader.set_names() before Reader.block()")
        try:
            return self.names.index(name.lower())
        except ValueError:
            raise KeyError("Name '%s' doesn't match to any columns." % name)

    def block(self, b: int, names, dtypes=None):
        """Parse the requested columns of block ``b``
        (ref go/text/text.go:179-200).  ``dtypes`` gives np.int64 or
        np.float32 per name (default float32).  Returns
        ``{name: array}``."""
        if dtypes is None:
            dtypes = [np.float32] * len(names)
        import time as _time

        t0 = _time.perf_counter()
        with self._read_lock:
            self.f.seek(self.block_starts[b])
            buf = self.f.read(self.block_sizes[b])
        t1 = _time.perf_counter()

        starts, ends = _data_line_spans(buf, self.config.comment,
                                        threads=self.threads)
        t2 = _time.perf_counter()

        col_idx = [self._name_index(n) for n in names]
        # integer columns take the exact int64 parse path (reference
        # strconv.Atoi, ref go/text/parse.go:118-121): IDs above 2^53
        # keep their low bits, and float syntax in an int column errors.
        # float32 columns (the common case) narrow inside the parser --
        # same one rounding as the old astype pass, minus the pass.
        def _kind(d):
            d = np.dtype(d)
            if np.issubdtype(d, np.integer):
                return 1
            return 2 if d == np.float32 else 0

        kinds = [_kind(d) for d in dtypes]
        cols = native.parse_columns(buf, starts, ends, col_idx,
                                    threads=self.threads,
                                    sep=self.config.separator,
                                    kinds=kinds)
        out = {}
        for name, dtype, col in zip(names, dtypes, cols):
            out[name] = col if col.dtype == dtype else col.astype(dtype)
        if self.timer is not None:
            t3 = _time.perf_counter()
            self.timer.add("read", t1 - t0, len(buf))
            self.timer.add("scan_lines", t2 - t1, len(buf))
            self.timer.add("parse", t3 - t2, len(buf))
        return out

    def close(self) -> None:
        if self.closer is not None:
            self.closer.close()


def _reader_size(f) -> int:
    pos = f.tell()
    size = f.seek(0, io.SEEK_END)
    f.seek(pos)
    return size


def _data_line_spans(buf: bytes, comment: bytes, threads: int = 0):
    """[start, end) byte spans of non-empty data lines, with trailing
    inline comments stripped (ref go/text/parse.go:16-78).

    Hot path is the native single-pass scanner (native/fastbits.cpp
    mnw_scan_lines); the numpy formulation below is the fallback."""
    spans = native.scan_lines(buf, comment, threads=threads)
    if spans is not None:
        return spans
    arr = np.frombuffer(buf, dtype=np.uint8)
    nl = np.nonzero(arr == ord(b"\n"))[0]
    starts = np.concatenate([[0], nl + 1]).astype(np.int64)
    ends = np.concatenate([nl, [len(buf)]]).astype(np.int64)

    # strip inline comments: truncate each line at its first comment byte
    comm_positions = np.nonzero(arr == comment[0])[0]
    if comm_positions.size:
        # for each line, the first comment at/after its start and before end
        idx = np.searchsorted(comm_positions, starts)
        has = (idx < comm_positions.size)
        first = np.where(has, comm_positions[np.minimum(
            idx, comm_positions.size - 1)], np.int64(np.iinfo(np.int64).max))
        ends = np.minimum(ends, first)

    keep = ends > starts
    starts, ends = starts[keep], ends[keep]
    # drop whitespace-only lines: per-span data-char counts via reduceat
    # (a whole-buffer cumsum ran at ~100 MB/s on this host)
    if starts.size:
        is_data = ~((arr == ord(" ")) | (arr == ord("\t"))
                    | (arr == ord("\r")) | (arr == ord("\n")))
        # sentinel so a span ending at len(buf) stays a valid reduceat index
        counts = np.concatenate([is_data.astype(np.int64), [0]])
        bounds = np.stack([starts, ends], axis=1).ravel()
        sums = np.add.reduceat(counts, bounds)[::2]
        nonempty = sums > 0
        starts, ends = starts[nonempty], ends[nonempty]
    return starts, ends


def open(fname, config: ReaderConfig = None) -> Reader:  # noqa: A001
    f = io.open(fname, "rb")
    return Reader(f, config, closer=f)


def open_from_bytes(data: bytes, config: ReaderConfig = None) -> Reader:
    """In-memory reader for tests (the reference's fakeReader pattern,
    ref go/text/text_test.go:9-19)."""
    return Reader(io.BytesIO(data), config)
