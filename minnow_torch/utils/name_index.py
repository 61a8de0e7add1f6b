"""Alias -> canonical column-name table
(ref scripts/name_index/name_index.go).

File format: one canonical name per line followed by its aliases,
whitespace-separated; lookups are case-insensitive.

The port's own copy of ``minnow_tpu/utils/name_index.py``: the same
arithmetic and the same bytes, on numpy, with no import from that
package.
"""

from __future__ import annotations

__all__ = ["Index", "open_index"]


def _clean(tokens):
    return [t.strip(" \n\t") for t in tokens if t.strip(" \n\t")]


class Index:
    """(ref name_index.go:9-56)"""

    def __init__(self, text: str):
        self.all_names: list[str] = []
        self._map: dict[str, str] = {}
        for line in _clean(text.split("\n")):
            toks = _clean(line.split(" "))
            if not toks:
                continue
            self.all_names.append(toks[0])
            for tok in toks:
                self._map[tok.lower()] = toks[0]

    def standardize(self, name: str):
        """Returns (canonical, found)."""
        low = name.lower()
        if low in self._map:
            return self._map[low], True
        return low, False


def open_index(fname: str) -> Index:
    with open(fname) as f:
        return Index(f.read())
