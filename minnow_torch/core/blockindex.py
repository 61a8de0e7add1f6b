"""Per-group cumulative block byte offsets (ref go/block_index.go).

The port's own copy of ``minnow_tpu/core/blockindex.py``: the same
arithmetic and the same bytes, on numpy, with no import from that
package.
"""

from __future__ import annotations


class BlockIndex:
    """Running byte offsets of a group's blocks, relative to the group's
    first block (ref go/block_index.go:7-39)."""

    def __init__(self, start_block: int):
        self.start_block = int(start_block)
        self.offsets: list[int] = []

    def add_block(self, size: int) -> None:
        if not self.offsets:
            self.offsets.append(int(size))
        else:
            self.offsets.append(int(size) + self.offsets[-1])

    def block_offset(self, b: int) -> int:
        if b < self.start_block or b >= self.start_block + len(self.offsets):
            raise IndexError(
                "Group contains blocks in range [%d, %d), but block %d was "
                "requested." % (self.start_block,
                                self.start_block + len(self.offsets), b))
        if b == self.start_block:
            return 0
        return self.offsets[b - self.start_block - 1]

    def blocks(self) -> int:
        return len(self.offsets)
