"""inspect_minh: summarize a minh catalog, with the columns read on a CUDA
device (counterpart of ``minnow_tpu/cli/inspect_minh.py``; ref
scripts/test_minh.py generalized).

Usage:
  python -m minnow_torch.cli.inspect_minh <file.minh> [column ...]
        [--device] [--plot OUT.png]

With ``--device`` the Float and Int columns are read on the CUDA device
(``formats.minh_device``, kernels K2 and K4), bitwise equal to the host
reader, so the summary is the host's; without a CUDA device ``--device``
is an error.  ``--plot`` writes the reference's sanity figure (needs
matplotlib).
"""

from __future__ import annotations

import sys

import numpy as np

# the reference's jax-free figure code; it reads columns through the
# callable it is given
from minnow_tpu.cli.inspect_minh import _plot
from minnow_tpu.formats import minh

from ..formats.minh_device import read_column
from ..utils.device import cuda_device

__all__ = ["inspect", "main"]

# the column types the summary covers (ref inspect_minh.py:139-143)
_TYPES = (minh.Float, minh.Int, minh.Float32, minh.Int64)


def inspect(fname: str, names=(), device=None, plot_out=None) -> None:
    """Print the summary of ``fname`` as the reference's ``main`` does:
    header, columns and the min, max and mean of each of ``names`` (all
    columns when empty).  ``device`` reads the Float and Int columns (a
    CUDA device runs the kernels, ``"cpu"`` their plain versions), None
    the host reader."""
    r = minh.open(fname, dither="none")
    try:
        print("file      :", fname)
        print("file type :", "boundary" if r.file_type else "basic")
        print("rows      :", r.length, "in", r.blocks, "blocks")
        print("geometry  : L=%g boundary=%g cells=%d"
              % (r.l, r.boundary, r.cells))
        print("text      :", (r.text[:60] + "...") if len(r.text) > 60
              else r.text)
        print("columns   :")
        for name, col in zip(r.names, r.columns):
            print("  %-20s %s" % (name, col))

        def read_col(name):
            return read_column(r, name, device)

        for name in names or r.names:
            if r.columns[r.names.index(name)].type not in _TYPES:
                continue
            data = read_col(name)
            print("%-20s min=%-12.6g max=%-12.6g mean=%-12.6g"
                  % (name, data.min(), data.max(),
                     float(np.mean(data.astype(np.float64)))))
        if plot_out:
            _plot(r, read_col, plot_out)
    finally:
        r.close()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        argv.remove("--device")
        device = cuda_device()
    plot_out = None
    if "--plot" in argv:
        i = argv.index("--plot")
        if i + 1 == len(argv):
            raise SystemExit("--plot needs an output path")
        plot_out = argv[i + 1]
        del argv[i:i + 2]
    if not argv:
        raise SystemExit(__doc__)
    inspect(argv[0], argv[1:], device, plot_out)


if __name__ == "__main__":
    main()
