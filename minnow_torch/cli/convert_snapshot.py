"""convert_snapshot: convert particle snapshots between LGadget-2 and
minp (counterpart of ``minnow_tpu/cli/convert_snapshot.py``; ref
scripts/convert_snapshot.go -- which does not compile as committed; this
implements its evident intent, SURVEY App. B #1).

Usage:
  python -m minnow_torch.cli.convert_snapshot to_minp <in_dir> <out_dir> \\
      <file_cells> <sub_cells> <dx> <dv> [--device]
  python -m minnow_torch.cli.convert_snapshot to_lgadget2 <in_dir> \\
      <fname_fmt> <out_dir>

Without ``--device`` the host writer encodes the minp files.  With
``--device`` each file's vectors are encoded on the CUDA device, one
batch of sub-cell blocks per axis (the port's ``BlockEncoder``, kernel
K1); without a CUDA device ``--device`` is an error.  The files are
byte-identical to the host writer's.  ``to_lgadget2`` is a host
conversion, which has no device mode.
"""

from __future__ import annotations

import sys

from ..ingest import lgadget2, snapshot
from ..parallel.pipeline import BlockEncoder
from ..utils import profiling
from ..utils.device import cuda_device

__all__ = ["to_minp", "to_lgadget2", "main"]


@profiling.traced("convert_snapshot.to_minp")
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


def to_lgadget2(in_dir: str, fname_fmt: str, out_dir: str) -> None:
    """Convert the minp fileset ``fname_fmt`` in ``in_dir`` back to
    LGadget-2 files ``snap_NNN.dat`` in ``out_dir``."""
    snap = snapshot.MinPSnapshot(in_dir, fname_fmt)
    hd = snap.header()
    gh = lgadget2.LGadget2Header(
        time=hd.scale, redshift=hd.z, box_size=hd.l,
        omega0=hd.omega_m, omega_lambda=hd.omega_l,
        hubble_param=hd.h100,
        n_part_total=(int(hd.n_total >> 32),
                      int(hd.n_total & 0xFFFFFFFF), 0, 0, 0, 0),
        num_files=snap.files())
    lgadget2.write_lgadget2(out_dir, "snap_%03d.dat", snap, gh)


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
        to_lgadget2(argv[1], argv[2], argv[3])
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
