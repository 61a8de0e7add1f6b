"""inspect_minh: summarize a minh catalog (counterpart of
``minnow_tpu/cli/inspect_minh.py``; ref scripts/test_minh.py generalized).

Usage:
  python -m minnow_torch.cli.inspect_minh <file.minh> [column ...]
        [--device] [--plot OUT.png]

Without ``--device`` the host reader reads the columns.  With
``--device`` the Float and Int columns are read on the CUDA device
(``formats.minh_device``, kernels K2 and K4), bitwise equal to the host
reader, so the summary is the host's; without a CUDA device ``--device``
is an error.

``--plot OUT.png`` writes the reference script's visual sanity checks
(ref scripts/test_minh.py:31-50, its commented-out slice plot plus a
mass function): an x-y position slice -- colored by the boundary flag
when the catalog has one -- and a log10-mass histogram when a ``mvir``
column exists.  Requires matplotlib; everything else works without it.
"""

from __future__ import annotations

import sys

import numpy as np

from ..formats import minh
from ..formats.minh_device import read_column
from ..utils.device import cuda_device

__all__ = ["inspect", "main"]

# the column types the summary covers (ref inspect_minh.py:139-143)
_TYPES = (minh.Float, minh.Int, minh.Float32, minh.Int64)


def _plot(r, read_col, out_png):
    """The reference's visual sanity checks (ref scripts/test_minh.py):
    x-y slice (boundary-colored when available) + mass function.
    ``read_col`` routes each column through the device or host reader
    by its type (raw Float32/Int64 columns have nothing to decode on
    device)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    have = set(r.names)
    panels = []
    if {"x", "y"} <= have:
        panels.append("slice")
    if "mvir" in have:
        panels.append("massfn")
    if not panels:
        raise SystemExit("--plot needs x/y and/or mvir columns")
    fig, axes = plt.subplots(1, len(panels),
                             figsize=(5.2 * len(panels), 4.6))
    axes = np.atleast_1d(axes)
    for ax, panel in zip(axes, panels):
        if panel == "slice":
            x, y = read_col("x"), read_col("y")
            keep = np.ones(len(x), bool)
            if "z" in have:  # the reference's thin-slice cut
                z = read_col("z")
                keep &= z < (r.l / 5 if r.l else np.median(z))
            if "boundary" in have:
                bnd = read_col("boundary")
                ax.plot(x[keep & (bnd == 0)], y[keep & (bnd == 0)],
                        ".", ms=1, c="r", label="interior")
                ax.plot(x[keep & (bnd != 0)], y[keep & (bnd != 0)],
                        ".", ms=1, c="k", label="boundary")
                ax.legend(markerscale=8, fontsize=8)
            else:
                ax.plot(x[keep], y[keep], ".", ms=1, c="k")
            ax.set_xlabel("$X$")
            ax.set_ylabel("$Y$")
            if r.l:
                ax.set_xlim(0, r.l)
                ax.set_ylim(0, r.l)
            ax.set_title("position slice")
        else:
            mvir = read_col("mvir")
            mvir = mvir[mvir > 0]
            ax.hist(np.log10(mvir.astype(np.float64)), bins=40,
                    histtype="step", color="k")
            ax.set_yscale("log")
            ax.set_xlabel(r"$\log_{10} M_{\rm vir}$")
            ax.set_ylabel("count")
            ax.set_title("mass function")
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    print("plot      :", out_png)


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
