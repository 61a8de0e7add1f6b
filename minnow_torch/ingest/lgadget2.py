"""LGadget-2 binary snapshot backend (ref go/minp/snapshot/lgadget2.go).

Fortran-record format: each block is guarded by int32 record lengths.
Layout per file:

  [i32][256-byte header][i32]
  [i32][positions: 3*N float32][i32]
  [i32][velocities: 3*N float32, internal units v/sqrt(a)][i32]
  [i32][IDs: N int64][i32]

Velocities are scaled by sqrt(a) on read (ref lgadget2.go:257-270);
positions are wrapped into [0, L) and NaN/Inf/out-of-range scanned --
the reference's corruption detection (ref lgadget2.go:216-225).

The port's own copy of ``minnow_tpu/ingest/lgadget2.py``: the same
arithmetic and the same bytes, on numpy, with no import from that
package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
import math
import os
import struct

import numpy as np

from ..formats import minp as minp_fmt
from ..utils import profiling
from . import snapshot as snap_mod

_HEADER_SIZE = 256
_HEADER_FMT = "<6I6d2d2i6I2i4d2i88s"


@dataclass
class LGadget2Header:
    """256-byte on-disk header (ref lgadget2.go:327-338)."""

    n_part: tuple = (0,) * 6
    mass: tuple = (0.0,) * 6
    time: float = 0.0
    redshift: float = 0.0
    flag_sfr: int = 0
    flag_feedback: int = 0
    n_part_total: tuple = (0,) * 6
    flag_cooling: int = 0
    num_files: int = 0
    box_size: float = 0.0
    omega0: float = 0.0
    omega_lambda: float = 0.0
    hubble_param: float = 0.0
    flag_stellar_age: int = 0
    hash_tab_size: int = 0
    padding: bytes = field(default=b"\0" * 88, repr=False)

    def pack(self) -> bytes:
        raw = struct.pack(
            _HEADER_FMT, *self.n_part, *self.mass, self.time,
            self.redshift, self.flag_sfr, self.flag_feedback,
            *self.n_part_total, self.flag_cooling, self.num_files,
            self.box_size, self.omega0, self.omega_lambda,
            self.hubble_param, self.flag_stellar_age, self.hash_tab_size,
            self.padding[:88].ljust(88, b"\0"))
        assert len(raw) == _HEADER_SIZE
        return raw

    @classmethod
    def unpack(cls, raw: bytes) -> "LGadget2Header":
        if len(raw) != _HEADER_SIZE:
            raise ValueError("length of buffer = %d, but "
                             "sizeof(LGadget2Header) = %d"
                             % (len(raw), _HEADER_SIZE))
        v = struct.unpack(_HEADER_FMT, raw)
        return cls(n_part=v[0:6], mass=v[6:12], time=v[12],
                   redshift=v[13], flag_sfr=v[14], flag_feedback=v[15],
                   n_part_total=v[16:22], flag_cooling=v[22],
                   num_files=v[23], box_size=v[24], omega0=v[25],
                   omega_lambda=v[26], hubble_param=v[27],
                   flag_stellar_age=v[28], hash_tab_size=v[29],
                   padding=v[30])

    def particle_count(self, n_part_num: int = 2) -> int:
        """64-bit count reconstruction from split uint32s
        (ref lgadget2.go:112-127)."""
        return _particle_num(self.n_part, n_part_num)

    def to_minp_header(self, n_part_num: int = 2) -> minp_fmt.Header:
        """(ref lgadget2.go:92-110)"""
        hd = minp_fmt.Header(
            z=self.redshift, scale=1.0 / (1.0 + self.redshift),
            l=self.box_size, omega_m=self.omega0,
            omega_l=self.omega_lambda, h100=self.hubble_param)
        hd.n_total = _particle_num(self.n_part_total, n_part_num)
        hd.n_side = _int_cube_root(hd.n_total)
        snap_mod.calc_uniform_mass(hd)
        return hd


def _particle_num(npart, n_part_num: int) -> int:
    if n_part_num == 2:
        if npart[0] > 100 * 1000:
            raise ValueError(
                "Simulation contains too many particles. This is probably "
                "because GadgetNpartNum is set to 2 when it should be 1.")
        return int(npart[1]) + (int(npart[0]) << 32)
    return int(npart[0])


def _int_cube_root(n: int) -> int:
    c = float(n) ** (1.0 / 3)
    hi, lo = math.ceil(c), math.floor(c)
    return int(hi if hi - c < c - lo else lo)


class CorruptionError(ValueError):
    pass


class LGadget2Snapshot(snap_mod.Snapshot):
    """(ref lgadget2.go:19-324)"""

    def __init__(self, dirname: str, n_part_num: int = 2):
        self.filenames = sorted(
            os.path.join(dirname, f) for f in os.listdir(dirname))
        if not self.filenames:
            raise FileNotFoundError("No files in directory %s" % dirname)
        self.n_part_num = n_part_num
        gh = self._read_header(self.filenames[0])
        self.hd = gh.to_minp_header(n_part_num)

    @staticmethod
    def _read_header(fname) -> LGadget2Header:
        with open(fname, "rb") as f:
            f.read(4)
            return LGadget2Header.unpack(f.read(_HEADER_SIZE))

    def files(self):
        return len(self.filenames)

    def header(self):
        return self.hd

    def raw_header(self, i):
        with open(self.filenames[i], "rb") as f:
            f.read(4)
            return f.read(_HEADER_SIZE)

    def update_header(self, hd):
        self.hd = hd

    def uniform_mass(self):
        return True

    def _open_data(self, i):
        f = open(self.filenames[i], "rb")
        f.read(4)
        gh = LGadget2Header.unpack(f.read(_HEADER_SIZE))
        f.read(4)
        count = gh.particle_count(self.n_part_num)
        return f, gh, count

    @profiling.traced("lgadget2.read")
    def read_x(self, i):
        f, gh, count = self._open_data(i)
        with f:
            f.read(4)
            x = np.frombuffer(f.read(12 * count), dtype="<f4").reshape(
                count, 3).copy()
        l = np.float32(gh.box_size)
        x = np.where(x < 0, x + l, x)
        x = np.where(x >= l, x - l, x)
        if (np.isnan(x).any() or np.isinf(x).any()
                or (x < 0).any() or (x >= l).any()):
            raise CorruptionError("Corruption detected in the file %s."
                                  % self.filenames[i])
        return x

    @profiling.traced("lgadget2.read")
    def read_v(self, i):
        f, gh, count = self._open_data(i)
        with f:
            f.seek(8 + count * 12, 1)
            f.read(4)
            v = np.frombuffer(f.read(12 * count), dtype="<f4").reshape(
                count, 3).copy()
        v *= np.float32(math.sqrt(gh.time))
        if np.isnan(v).any() or np.isinf(v).any():
            raise CorruptionError("Corruption detected in the file %s."
                                  % self.filenames[i])
        return v

    @profiling.traced("lgadget2.read")
    def read_id(self, i):
        f, gh, count = self._open_data(i)
        with f:
            f.seek(16 + count * 24, 1)
            f.read(4)
            ids = np.frombuffer(f.read(8 * count), dtype="<i8").copy()
        return ids


def write_lgadget2(dirname: str, fname_fmt: str,
                   snap: snap_mod.Snapshot, gh: LGadget2Header) -> None:
    """Re-emit a snapshot in LGadget-2 format
    (ref lgadget2.go:386-448)."""
    root_a = np.float32(math.sqrt(gh.time))
    for i in range(snap.files()):
        x = np.asarray(snap.read_x(i), np.float32)
        gh.n_part = (0, len(x), 0, 0, 0, 0)
        with open(os.path.join(dirname, fname_fmt % i), "wb") as f:
            hdr = gh.pack()
            f.write(struct.pack("<i", len(hdr)))
            f.write(hdr)
            f.write(struct.pack("<i", len(hdr)))

            xb = x.astype("<f4").tobytes()
            f.write(struct.pack("<i", len(xb)))
            f.write(xb)
            f.write(struct.pack("<i", len(xb)))

            v = np.asarray(snap.read_v(i), np.float32) / root_a
            vb = v.astype("<f4").tobytes()
            f.write(struct.pack("<i", len(xb)))
            f.write(vb)
            f.write(struct.pack("<i", len(xb)))

            ids = np.asarray(snap.read_id(i), np.int64).astype("<i8")
            ib = ids.tobytes()
            f.write(struct.pack("<i", len(ib)))
            f.write(ib)
            f.write(struct.pack("<i", len(ib)))
