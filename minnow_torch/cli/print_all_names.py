"""print_all_names: audit the column names of text catalogs against a
name index (a copy of ``minnow_tpu/cli/print_all_names.py``; ref
scripts/print_all_names.go, generalized from its hard-coded site paths).

Usage:
  python -m minnow_torch.cli.print_all_names <glob> [name_index]
"""

from __future__ import annotations

import glob as globmod
import sys

from ..ingest import rockstar
from ..utils.name_index import open_index


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (1, 2):
        raise SystemExit(__doc__)
    idx = open_index(argv[1]) if len(argv) == 2 else None

    seen = set()
    for fname in sorted(globmod.glob(argv[0])):
        r = rockstar.open_rockstar(fname)
        names = r.names()
        r.close()
        for name in names:
            if name in seen:
                continue
            seen.add(name)
            if idx is None:
                print(name)
            else:
                std, ok = idx.standardize(name)
                print("%-30s -> %s%s" % (name, std,
                                         "" if ok else "   [NOT IN INDEX]"))


if __name__ == "__main__":
    main()
