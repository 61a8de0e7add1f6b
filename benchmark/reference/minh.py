"""The plain reference of a halo catalog's conversion and read-back.

From the text catalog the benchmark wrote, and the deployment's settings,
it works out the minh file that ``text_to_minh`` has to write, byte for
byte, and the values a bulk read of that file has to give:

- the text: the leading ``#`` lines are the file's free text, the first
  of them names the columns, every other line is a row of single-spaced
  fields; the stored columns' fields are parsed by numpy's own number
  parsers (floats to float64, then float32; ints exactly);
- the mass cut: rows whose float32 mass exceeds ``float32(Mp *
  MinParticles)``;
- each column's storage: ``int64`` raw, ``int`` min-subtracted and
  packed, ``q_float`` log10'd (Go's fdlibm) where it is a log column,
  clamped to ``[low, nextafter(high, -inf)]``, quantized at its ``dx``
  over ``[low, high)`` and packed on its periodic window;
- the minh layout: header 0 ``(0xBAFF1ED, 0, 0)``, the text, the names
  joined by ``$``, one 256-byte record a column, then one group a column
  of the single row-block, then geometry ``(L f32, 0 f32, 0 i64)``, the
  block count and the blocks' lengths.
"""

from __future__ import annotations

import math
import re
import struct

import numpy as np

from . import codec
from .container import Container

MAGIC = 0xBAFF1ED
INT64, INT, FLOAT = 0, 10, 11


def parse_text(path: str, names: dict):
    """``(text, columns, values)``: the comment header, the canonical
    names of the columns that ``names`` holds, in file order (``names``
    maps a header name, lower case, to its canonical name; a
    consistent-trees header, one with a ``(0)``, has each name's trailing
    ``(i)`` dropped), and those columns' fields as bytes strings.  Every
    row has one field a column, single-spaced."""
    with open(path, "rb") as f:
        buf = f.read()
    pos, head = 0, []
    while buf.startswith(b"#", pos):
        end = buf.index(b"\n", pos)
        head.append(buf[pos:end])
        pos = end + 1
    text = b"\n".join(head).decode()
    first = head[0][1:].decode()
    tokens = [t for t in first.split(" ") if t]
    if "(0)" in first:
        tokens = [re.sub(r"\([^(]*\)$", "", t) for t in tokens]
    body = np.frombuffer(buf, np.uint8, offset=pos)
    ncol = len(tokens)
    sep = np.flatnonzero((body == ord(" ")) | (body == ord("\n")))
    if (sep.size % ncol or sep[-1] != body.size - 1
            or (body[sep[ncol - 1::ncol]] != ord("\n")).any()
            or (np.diff(sep) < 2).any() or sep[0] == 0):
        raise ValueError("%s: the rows are not %d single-spaced fields"
                         % (path, ncol))
    cols, values = [], {}
    for j, t in enumerate(tokens):
        if t.lower() not in names:
            continue
        ends = sep[j::ncol]
        starts = (sep[j - 1::ncol] if j else
                  np.concatenate([[-1], sep[ncol - 1:-1:ncol]])) + 1
        width = int((ends - starts).max())
        idx = starts[:, None] + np.arange(width)
        inside = idx < ends[:, None]
        field = np.where(inside, body[np.where(inside, idx, 0)], 0)
        cols.append(names[t.lower()])
        values[cols[-1]] = field.astype(np.uint8).view("S%d" % width)[:, 0]
    return text, cols, values


class Column:
    """A column's storage as the deployment's type index gives it."""

    def __init__(self, kind: list, box: float, epsilon: float):
        self.kind = kind[0]
        self.log, self.low, self.high, self.dx = 0, 0.0, 0.0, 0.0
        if self.kind == "int64":
            self.type = INT64
        elif self.kind == "int":
            self.type = INT
        elif self.kind == "q_float":
            self.type = FLOAT
            if kind[1] == "position":
                self.low, self.high, self.dx = 0.0, box, epsilon
            else:
                lo, hi, self.dx = (float(v) for v in kind[2:5])
                if kind[1] == "log":
                    self.log = 1
                    lo, hi = math.log10(lo), math.log10(hi)
                self.low, self.high = lo, hi
        else:
            raise ValueError("column type %r" % kind)

    def record(self) -> bytes:
        return (struct.pack("<qifff", self.type, self.log,
                            np.float32(self.low), np.float32(self.high),
                            np.float32(self.dx)) + b"\0" * 232)

    @property
    def pixels(self) -> int:
        return codec.float_group_pixels(self.low, self.high, self.dx)

    def stored(self, raw) -> np.ndarray:
        """The parsed column as it is quantized: float32, log10'd for a
        log column, clamped below ``high``."""
        x = raw.astype(np.float64).astype(np.float32)
        if self.log:
            x = codec.log10_f32(x)
        hi = np.float32(self.high)
        x = np.where(x < np.float32(self.low), np.float32(self.low), x)
        return np.where(x >= hi, np.nextafter(hi, np.float32(-np.inf)), x)


class Catalog:
    """A catalog worked out from its text: ``file_bytes()`` is the minh
    file, ``decoded(seed)`` the values its read gives."""

    def __init__(self, hlist: str, cfg: dict, lower=None):
        names = {}
        for canon, *aliases in cfg["names"]:
            if canon in cfg["types"]:
                for n in [canon] + aliases:
                    names[n.lower()] = canon
        self.text, self.names, fields = parse_text(hlist, names)
        self.cols = [Column(cfg["types"][n], cfg["L"], cfg["epsilon"])
                     for n in self.names]
        mass = fields[cfg["mass_name"]].astype(np.float64).astype(
            np.float32)
        keep = mass > np.float32(cfg["Mp"] * cfg["min_particles"])
        self.values = {}
        for n, col in zip(self.names, self.cols):
            raw = fields[n][keep]
            if col.type == FLOAT:
                x = col.stored(raw)
                # ``lower`` rounds to a lower precision: the control
                self.values[n] = x if lower is None else lower(x)
            else:
                self.values[n] = raw.astype(np.int64)
        self.rows = int(keep.sum())
        self.box = cfg["L"]
        self._encode()

    def _encode(self):
        fl = [i for i, c in enumerate(self.cols) if c.type == FLOAT]
        it = [i for i, c in enumerate(self.cols) if c.type == INT]
        self.enc = {}
        if fl:
            x = np.stack([self.values[self.names[i]] for i in fl])
            low = [self.cols[i].low for i in fl]
            high = [self.cols[i].high for i in fl]
            pix = [self.cols[i].pixels for i in fl]
            mins, bits, deltas, q = codec.encode_float_rows(x, low, high,
                                                            pix)
            pay = codec.payloads(deltas, bits)
            for r, i in enumerate(fl):
                self.enc[i] = (mins[r], bits[r], pay[r], q[r])
        if it:
            x = np.stack([self.values[self.names[i]] for i in it])
            mins, bits, deltas = codec.encode_int_rows(x)
            pay = codec.payloads(deltas, bits)
            for r, i in enumerate(it):
                self.enc[i] = (mins[r], bits[r], pay[r], None)

    def file_bytes(self) -> bytes:
        c = Container()
        c.header(struct.pack("<qqq", MAGIC, 0, 0))
        c.header(self.text.encode())
        c.header("$".join(self.names).encode())
        c.header(b"".join(col.record() for col in self.cols))
        for i, col in enumerate(self.cols):
            n = self.rows
            if col.type == INT64:
                c.fixed_group(self.values[self.names[i]].astype("<i8"))
            elif col.type == INT:
                mn, bits, pay, _ = self.enc[i]
                c.int_group(n, [mn], [bits], [pay])
            else:
                mn, bits, pay, _ = self.enc[i]
                c.float_group(n, col.low, col.high, col.pixels, [mn], [bits],
                              [pay])
        c.header(struct.pack("<ffq", np.float32(self.box), 0, 0))
        c.header(struct.pack("<q", 1))
        c.header(np.asarray([self.rows], "<i8").tobytes())
        return c.bytes()

    def decoded(self, seed: int = 0) -> dict:
        """Each column as a bulk read gives it, floats with the
        ``uniform`` dither keyed on ``seed`` and the column's container
        block (the column's index: one row-block)."""
        out = {}
        for i, (n, col) in enumerate(zip(self.names, self.cols)):
            if col.type != FLOAT:
                out[n] = self.values[n]
                continue
            q = self.enc[i][3][None, :]
            p = col.pixels
            q = codec.wrap(q, 0, p)
            u = codec.dither_u(seed, [i], self.rows)
            x = codec.dequantize(q, col.low, col.high, p, u)[0]
            if col.log:
                x = np.float32(np.power(10.0, x.astype(np.float64)))
            out[n] = x
        return out
