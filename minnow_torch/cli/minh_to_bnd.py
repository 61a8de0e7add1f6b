"""minh_to_bnd: convert basic minh catalogs to the spatial boundary
layout (counterpart of ``minnow_tpu/cli/minh_to_bnd.py``; ref
scripts/minh_to_bnd.go).

Usage:
  python -m minnow_torch.cli.minh_to_bnd <cells> <boundary> <glob> <outdir>
        [--device]

Without ``--device`` the host reader and writer do the conversion.  With
``--device`` every Float and Int column is read on the CUDA device
(``formats.minh_device``, kernels K2 and K4) and every cell group of
those columns is encoded there (``create_boundary`` with the port's
``BlockEncoder``, kernels K1 and K3); without a CUDA device ``--device``
is an error.  The device reads equal the host reader bitwise in every
dither mode and the device encode equals the host codec, so the file is
byte-identical to the host conversion's.  Raw ``Float32`` and ``Int64``
columns are host reads and host writes in both modes.
"""

from __future__ import annotations

import glob as globmod
import os
import sys
import time

import numpy as np

from ..formats import boundary, minh
from ..formats.minh_device import read_column
from ..parallel.pipeline import BlockEncoder
from ..utils import profiling
from ..utils.device import cuda_device

__all__ = ["out_name", "convert_file", "main"]

# the column types the reference converts (ref minh_to_bnd.go:61-73)
_TYPES = (minh.Float, minh.Int, minh.Float32, minh.Int64)


def out_name(out_dir: str, fname: str) -> str:
    """(ref minh_to_bnd.go:41-50)"""
    base = os.path.basename(fname)
    toks = base.split(".")
    toks = toks[:-1] + ["bnd", "minh"] if len(toks) > 1 \
        else [base, "bnd", "minh"]
    return os.path.join(out_dir, ".".join(toks))


@profiling.traced("minh_to_bnd.convert_file")
def convert_file(in_name: str, out_name_: str, cells: int, bnd: float,
                 device=None, dither: str = "uniform") -> None:
    """Convert one basic minh file (ref minh_to_bnd.go:52-78).

    ``device`` is the torch device that decodes and encodes the Float
    and Int columns (a CUDA device runs the kernels, ``"cpu"`` their
    plain versions), or None for the host reader and writer.  The float
    columns are read with ``dither``, as the reference reads them.  Every
    call records its spans (``utils.profiling``),
    ``minh_to_bnd.convert_file`` the root."""
    rd = minh.open(in_name, dither=dither)
    try:
        w = boundary.create_boundary(
            out_name_, None if device is None else BlockEncoder(device))
        w.header(rd.text)
        w.geometry(rd.l, np.float32(bnd), cells)
        w.coordinates(*(read_column(rd, name, device)
                        for name in ("x", "y", "z")))
        for name, col in zip(rd.names, rd.columns):
            if col.type in _TYPES:
                w.column(name, col, read_column(rd, name, device))
        w.close()
    finally:
        rd.close()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        argv.remove("--device")
        device = cuda_device()
    if len(argv) != 4:
        raise SystemExit(__doc__)
    cells = int(argv[0])
    bnd = float(argv[1])
    for fname in globmod.glob(argv[2]):
        print("Converting", fname)
        t0 = time.time()
        convert_file(fname, out_name(argv[3], fname), cells, bnd, device)
        print("    %.2f minutes" % ((time.time() - t0) / 60))


if __name__ == "__main__":
    main()
