"""verify_minnow: integrity check for minnow/minh/minp files (a copy of
``minnow_tpu/cli/verify_minnow.py``; host only).

The failure-detection subsystem (SURVEY.md section 5.3): the formats'
magic/version guards detect files left invalid by a crashed writer (the
48-byte header is zeros until close, ref go/writer.go:36-37,131-140);
this tool extends that to structural tail validation and an optional
full decode pass.

Usage:
  python -m minnow_torch.cli.verify_minnow <file> [--deep]

Exit status: 0 valid, 1 invalid/corrupt.
"""

from __future__ import annotations

import os
import struct
import sys

from ..core import reader
from ..core.types import MAGIC, VERSION


def verify(fname: str, deep: bool = False) -> list:
    """Returns a list of problems (empty = valid)."""
    problems = []
    size = os.path.getsize(fname)
    if size < 48:
        return ["file smaller than the 48-byte minnow header"]
    with open(fname, "rb") as f:
        magic, version, groups, headers, blocks, tail_start = \
            struct.unpack("<QQQQQq", f.read(48))
    if magic == 0:
        return ["zero magic number: writer never closed "
                "(crashed/interrupted run)"]
    if magic != MAGIC:
        return ["bad magic number 0x%x (want 0x%x)"
                % (magic, MAGIC)]
    if version != VERSION:
        problems.append("version %d (reader is %d)"
                        % (version, VERSION))
    if not 48 <= tail_start <= size:
        return problems + ["tail offset %d outside file of %d bytes"
                           % (tail_start, size)]

    try:
        r = reader.open(fname, dither="none")
    except Exception as e:  # noqa: BLE001 - report, don't crash
        return problems + ["tail parse failed: %s" % e]

    try:
        # structural checks: header/block extents within the file
        for i in range(r.headers):
            off, sz = int(r.header_offsets[i]), int(r.header_sizes[i])
            if not (48 <= off and off + sz <= tail_start):
                problems.append("header %d extent [%d, %d) escapes data "
                                "region" % (i, off, off + sz))
        for g, grp in enumerate(r.readers):
            off = int(r.group_offsets[g])
            nb = grp.blocks()
            if nb:
                last = grp.start_block + nb - 1
                end = off + grp.block_offset(last)
                if not (48 <= off and end <= tail_start):
                    problems.append(
                        "group %d blocks escape data region" % g)
        if deep:
            for b in range(r.blocks()):
                try:
                    r.data(b)
                except Exception as e:  # noqa: BLE001
                    problems.append("block %d decode failed: %s" % (b, e))
    except Exception as e:  # noqa: BLE001 - corrupt tails take odd shapes
        problems.append("structural check failed: %s" % e)
    finally:
        r.close()
    return problems


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__)
    deep = "--deep" in argv
    if deep:
        argv.remove("--deep")
    bad = 0
    for fname in argv:
        problems = verify(fname, deep=deep)
        if problems:
            bad = 1
            print("%s: INVALID" % fname)
            for p in problems:
                print("  -", p)
        else:
            print("%s: ok" % fname)
    sys.exit(bad)


if __name__ == "__main__":
    main()
