"""A particle snapshot, made from a seed.

The model (from the port's ``chip_smoke.py`` ``write_snapshot``): a
particle sits at its Lagrangian lattice site plus a Gaussian displacement,
except in a share of the cubic patches of ``patch_sites`` sites, whose
particles collapse to a Gaussian cluster at the patch's centre; positions
wrap into ``[0, L)``.  Velocities are Gaussian.  Everything is drawn in
float32, in a few whole-array calls.

``write_gadget`` writes it as an LGadget-2 fileset in random particle
order, as a simulation's output files hold it.
"""

from __future__ import annotations

import os
import struct

import numpy as np

GADGET_HEADER = "<6I6d2d2i6I2i4d2i88s"


def make(cfg: dict, seed: int):
    """``(x, v)``: (N, 3) float32 positions and velocities in Lagrangian
    order (particle ``i`` has ID ``i + 1``)."""
    g = cfg["snapshot"]
    ns, box = cfg["n_side"], np.float32(cfg["L"])
    rng = np.random.default_rng(seed)
    n = ns ** 3
    lag = np.arange(n, dtype=np.int32)
    site = np.stack([lag % ns, lag // ns % ns, lag // (ns * ns)], axis=1)
    del lag
    side = box / np.float32(ns)
    x = (site.astype(np.float32) + np.float32(0.5)) * side
    x += rng.standard_normal((n, 3), dtype=np.float32) * np.float32(
        g["displacement_sigma"])
    ps = g["patch_sites"]
    patch = site // ps
    del site
    pn = ns // ps
    pid = patch[:, 0] + pn * (patch[:, 1] + pn * patch[:, 2])
    inside = (rng.random(pn ** 3) < g["cluster_fraction"])[pid]
    centre = (patch[inside].astype(np.float32) + np.float32(0.5)) * (
        np.float32(ps) * side)
    x[inside] = centre + rng.standard_normal(
        centre.shape, dtype=np.float32) * np.float32(g["cluster_sigma"])
    x = np.mod(x, box)
    x = np.where(x >= box, x - box, x)
    v = rng.standard_normal((n, 3), dtype=np.float32) * np.float32(
        g["velocity_sigma"])
    return x, v


def gadget_header(cfg: dict, count: int, files: int) -> bytes:
    """A 256-byte LGadget-2 header for a file of ``count`` particles at
    ``a = 1``: counts split high/low into two 32-bit words."""
    n = cfg["n_side"] ** 3
    c = cfg["cosmology"]
    return struct.pack(GADGET_HEADER, count >> 32, count & 0xFFFFFFFF,
                       0, 0, 0, 0, *([0.0] * 6), 1.0, 0.0, 0, 0,
                       n >> 32, n & 0xFFFFFFFF, 0, 0, 0, 0, 0, files,
                       cfg["L"], c["omega_m"], c["omega_l"], c["h100"],
                       0, 0, b"\0" * 88)


def write_gadget(directory: str, cfg: dict, x, v, seed: int) -> None:
    """Write ``x``, ``v`` and their IDs as ``cfg["snapshot"]["files"]``
    LGadget-2 files ``snap_NNN.dat``, the particles in a random order
    drawn from ``seed``."""
    files = cfg["snapshot"]["files"]
    order = np.random.default_rng([seed, 1]).permutation(len(x))
    for i, o in enumerate(np.array_split(order, files)):
        hdr = gadget_header(cfg, len(o), files)
        with open(os.path.join(directory, "snap_%03d.dat" % i), "wb") as f:
            for rec in (hdr, x[o], v[o], (o + 1).astype("<i8")):
                data = rec if isinstance(rec, bytes) else memoryview(
                    np.ascontiguousarray(rec)).cast("B")
                mark = struct.pack("<i", len(data) & 0x7FFFFFFF)
                f.write(mark)
                f.write(data)
                f.write(mark)
