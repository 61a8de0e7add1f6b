"""convert_snapshot: convert particle snapshots between LGadget-2 and
minp, with the minp encode on a CUDA device (counterpart of
``minnow_tpu/cli/convert_snapshot.py``; ref scripts/convert_snapshot.go).

Usage:
  python -m minnow_torch.cli.convert_snapshot to_minp <in_dir> <out_dir> \\
      <file_cells> <sub_cells> <dx> <dv> [--device]
  python -m minnow_torch.cli.convert_snapshot to_lgadget2 <in_dir> \\
      <fname_fmt> <out_dir>

With ``--device`` each file's vectors are encoded on the CUDA device, one
batch of sub-cell blocks per axis (the port's ``BlockEncoder``, kernel
K1); without a CUDA device ``--device`` is an error.  The files are
byte-identical to the host writer's.  ``to_lgadget2`` is the reference's
host conversion, which has no device mode.
"""

from __future__ import annotations

import sys

# the reference's host layers, jax-free; minp.Writer only calls the
# encoder it is given, here the port's BlockEncoder
from minnow_tpu.cli import convert_snapshot as ref_convert_snapshot
from minnow_tpu.ingest import lgadget2, snapshot

from ..parallel.pipeline import BlockEncoder
from ..utils.device import cuda_device

__all__ = ["to_minp", "main"]


def to_minp(in_dir: str, out_dir: str, file_cells: int, sub_cells: int,
            dx: float, dv: float, device=None) -> None:
    """Convert the LGadget-2 snapshot in ``in_dir`` to a minp fileset in
    ``out_dir`` (``x_<i>.minp`` and ``v_<i>.minp``).  ``device`` is the
    torch device that encodes the vectors (a CUDA device runs K1,
    ``"cpu"`` its plain version), or None for the host writer."""
    snap = lgadget2.LGadget2Snapshot(in_dir)
    encoder = None if device is None else BlockEncoder(device)
    snapshot.write_minp(out_dir, "%s_%d.minp", file_cells, sub_cells, dx,
                        dv, snap, encoder=encoder)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        argv.remove("--device")
        device = cuda_device()
    if argv[:1] == ["to_minp"] and len(argv) == 7:
        to_minp(argv[1], argv[2], int(argv[3]), int(argv[4]),
                float(argv[5]), float(argv[6]), device)
    elif argv[:1] == ["to_lgadget2"] and len(argv) == 4:
        ref_convert_snapshot.main(argv)
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
