"""Rockstar / consistent-trees header dialects (ref go/text/rockstar.go).

Column names come from the first header line: plain Rockstar headers are
``#ID DescID ...``; consistent-trees headers carry ``name(idx)`` tokens
(detected by the presence of ``(0)`` -- ref go/text/rockstar.go:16-23).

The port's own copy of ``minnow_tpu/ingest/rockstar.py``: the same
arithmetic and the same bytes, on numpy, with no import from that
package.
"""

from __future__ import annotations

from . import text as text_mod


class Rockstar:
    """(ref go/text/rockstar.go:7-61)"""

    def __init__(self, rd: text_mod.Reader):
        self.rd = rd

    def names(self) -> list[str]:
        first = self.rd.line_header(1)
        if "(0)" in first:
            return consistent_trees_names(first)
        return rockstar_names(first)

    def header(self) -> str:
        return self.rd.comment_header()

    def set_threads(self, n: int) -> None:
        self.rd.set_threads(n)

    def set_timer(self, timer) -> None:
        self.rd.set_timer(timer)

    def set_names(self, names) -> None:
        self.rd.set_names(names)

    def blocks(self) -> int:
        return self.rd.blocks()

    def block(self, b, names, dtypes=None):
        return self.rd.block(b, names, dtypes)

    def close(self) -> None:
        self.rd.close()


def rockstar_names(line: str) -> list[str]:
    """(ref go/text/rockstar.go:25-36)"""
    names = [n.strip(" \n\t") for n in line[1:].split(" ")]
    return [n for n in names if n]


def consistent_trees_names(line: str) -> list[str]:
    """Strip the trailing ``(idx)`` from each token
    (ref go/text/rockstar.go:38-52; note the reference returns the
    unfiltered list -- SURVEY App. B #6 -- we filter empties)."""
    names = rockstar_names(line)
    out = []
    for n in names:
        toks = n.split("(")
        n = "(".join(toks[:-1]).strip(" \n\t")
        if n:
            out.append(n)
    return out


def open_rockstar(fname, config=None) -> Rockstar:
    return Rockstar(text_mod.open(fname, config))
