"""File-level dry runs of the several-device encoder (counterpart of
``__graft_entry__.py``: ``entry``, ``encode_step`` and
``dryrun_multichip`` with its ``_dryrun_*`` steps).

    python3 -m minnow_torch.tools.dryrun [--devices=cpu,cpu,cpu]

Each step sends inputs made with numpy from a seed (the reference's own
seeds and shapes) through ``BlockEncoder(devices)`` -- a contiguous share
of every batch's blocks on each device of the list, a device may stand in
it several times -- and holds what comes out, whole files where the step
writes one, byte for byte against the port's host writer, the host reader
or ``core.spec``.  Without ``--devices`` the list is the CUDA device,
which raises without a card; ``cpu`` entries run the kernels' plain
versions.  :func:`dryrun` runs every step and returns what each produced,
so that a test can hold the same bytes against the reference's.

The reference's first step, the 2-D (blocks x elements) mesh of
``dryrun_multichip`` (``__graft_entry__.py:98-151``), has no twin here:
the port splits a batch by blocks only, and a block is never split over
devices.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

from minnow_torch.core import spec
from minnow_torch.formats import boundary, minh, minp
from minnow_torch.formats.device_common import read_payloads
from minnow_torch.parallel.distributed import gather_blocks
from minnow_torch.parallel.pipeline import BlockEncoder

__all__ = ["entry", "encode_step", "dryrun", "dryrun_pallas_shard",
           "dryrun_production_writer", "dryrun_sharded_decode",
           "dryrun_minp_mesh", "dryrun_boundary_mesh",
           "dryrun_ragged_buckets", "STEPS"]

# the flagship config: positions in a box of 250 at 0.001 -> 250,000
# pixels -> 18 bits
_LOW, _HIGH, _DX = 0.0, 250.0, 0.001
_BITS = 18


def _example_batch(b, n, seed=0):
    rng = np.random.default_rng(seed)
    pixels = spec.float_group_pixels(_LOW, _HIGH, _DX)
    x = rng.uniform(0.0, 249.9, (b, n)).astype(np.float32)
    return (x, np.full(b, _LOW, np.float32), np.full(b, _HIGH, np.float32),
            np.full(b, pixels, np.int64), np.full(b, n, np.int64),
            np.ones(b, bool))


def _same_blocks(got, want, what: str) -> None:
    if got.payloads != want.payloads:
        raise AssertionError("%s: payloads differ" % what)
    for field in ("mins", "bits", "lens"):
        if not np.array_equal(getattr(got, field), getattr(want, field)):
            raise AssertionError("%s: %s differ" % (what, field))


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def encode_step(devices, x, low, high, pixels, lens, periodic):
    """The flagship encode step: one float batch through
    ``BlockEncoder(devices).encode_float_blocks``."""
    return BlockEncoder(devices).encode_float_blocks(
        x, low, high, pixels, lens=lens, periodic=periodic)


def entry(devices):
    """One batch of 8 x 32,768 flagship positions through
    :func:`encode_step`; every block must be ``spec.encode_float_block``'s
    bytes, minimum and width (18 bits).  Returns the encoded blocks."""
    args = _example_batch(8, 32768)
    enc = encode_step(devices, *args)
    x, low, high, pixels, lens, periodic = args
    for i in range(len(x)):
        payload, mn, bits, _ = spec.encode_float_block(
            x[i], low[i], high[i], int(pixels[i]), bool(periodic[i]))
        if (enc.payloads[i], int(enc.mins[i]), int(enc.bits[i])) != (
                payload, mn, bits) or bits != _BITS:
            raise AssertionError("entry: block %d differs from spec" % i)
    return enc


def dryrun_pallas_shard(devices):
    """The float encode kernel (K1; its plain version on the CPU) on each
    device's share of 8 blocks of 512, joined, must be byte-identical to
    the first device's encode of the whole batch."""
    rng = np.random.default_rng(5)
    pixels = spec.float_group_pixels(_LOW, _HIGH, _DX)
    x = rng.uniform(0, 249.9, (8, 512)).astype(np.float32)
    want = BlockEncoder(devices[0]).encode_float_blocks(x, _LOW, _HIGH,
                                                        pixels)
    got = BlockEncoder(devices).encode_float_blocks(x, _LOW, _HIGH, pixels)
    _same_blocks(got, want, "sharded float encode")
    return got


def dryrun_production_writer(devices) -> bytes:
    """The whole production writer path over the devices: ragged
    row-blocks -> ``BlockEncoder`` (several widths) -> ``gather_blocks``
    (one process) -> ``minh.Writer.encoded_block`` -> a minh file,
    byte-compared with a single-process host write (the writer-order
    contract, ref go/block_index.go:16-23).  Returns the file's bytes."""
    names = ["id", "x", "mvir"]
    cols = [minh.Column(type=minh.Int),
            minh.Column(type=minh.Float, low=_LOW, high=_HIGH, dx=_DX),
            minh.Column(type=minh.Float, low=1e9, high=1e15, dx=1e9)]
    sizes = [96, 57, 128]  # ragged row-block lengths
    rng = np.random.default_rng(3)
    blocks = [(rng.integers(0, 1 << 40, m).astype(np.int64),
               rng.uniform(0, 249.9, m).astype(np.float32),
               rng.uniform(1e9, 1e15, m).astype(np.float32)) for m in sizes]

    be = BlockEncoder(devices)
    nmax = max(sizes)
    ib = np.zeros((len(blocks), nmax), np.int64)
    for r, (ids, _, _) in enumerate(blocks):
        ib[r, :len(ids)] = ids
    enc_i = gather_blocks(be.encode_int_blocks(
        ib, lens=np.asarray(sizes, np.int64)))

    fcols = [1, 2]
    nf = len(blocks) * len(fcols)
    fb = np.zeros((nf, nmax), np.float32)
    flens = np.zeros(nf, np.int64)
    flow, fhigh = np.zeros(nf, np.float32), np.zeros(nf, np.float32)
    fpix = np.zeros(nf, np.int64)
    k = 0
    for bdata in blocks:
        for c in fcols:
            col = cols[c]
            data = minh.process_float_column(bdata[c], col)
            fb[k, :len(data)] = data
            flens[k] = len(data)
            flow[k], fhigh[k] = col.low, col.high
            fpix[k] = spec.float_group_pixels(col.low, col.high, col.dx)
            k += 1
    enc_f = gather_blocks(be.encode_float_blocks(fb, flow, fhigh, fpix,
                                                 lens=flens))
    if len({int(b) for b in enc_f.bits}) < 2:
        raise AssertionError("the dry run must pack at several widths")

    with tempfile.TemporaryDirectory() as td:
        dev_file = os.path.join(td, "dev.minh")
        w = minh.create(dev_file)
        w.header(names, "dryrun production writer", cols)
        w.geometry(_HIGH, 0, 0)
        for g, m in enumerate(sizes):
            w.encoded_block(m, [enc_i.block(g)] + [
                enc_f.block(g * len(fcols) + k) for k in range(len(fcols))])
        w.close()

        host_file = os.path.join(td, "host.minh")
        w = minh.create(host_file)
        w.header(names, "dryrun production writer", cols)
        w.geometry(_HIGH, 0, 0)
        for ids, xs, mv in blocks:
            w.block([ids, xs, mv])
        w.close()

        dev_bytes = _read(dev_file)
        if dev_bytes != _read(host_file):
            raise AssertionError("sharded production write differs from "
                                 "the host write")
    return dev_bytes


def dryrun_sharded_decode(devices) -> dict:
    """A host-written minh file's int and float columns decoded with the
    block axis shared over the devices (``decode_int_blocks``,
    ``decode_float_blocks``), bitwise equal to the host reader in the
    ``none``, ``midpoint`` and ``uniform`` dither modes (ref
    go/reader.go:114-127, go/minh/minh.go:232-265).  Returns the decoded
    columns, ``{"id": ..., "x none": ..., ...}``."""
    rng = np.random.default_rng(9)
    m, nblk = 128, 6
    cols = [minh.Column(type=minh.Int),
            minh.Column(type=minh.Float, low=_LOW, high=_HIGH, dx=_DX)]
    blocks = [(rng.integers(0, 1 << 45, m).astype(np.int64),
               rng.uniform(0, 249.9, m).astype(np.float32))
              for _ in range(nblk)]
    be = BlockEncoder(devices)
    out = {}
    with tempfile.TemporaryDirectory() as td:
        fname = os.path.join(td, "dec.minh")
        w = minh.create(fname)
        w.header(["id", "x"], "sharded decode dryrun", cols)
        w.geometry(_HIGH, 0, 0)
        for ids, xs in blocks:
            w.block([ids, xs])
        w.close()

        for mode in ("none", "midpoint", "uniform"):
            r = minh.open(fname, dither=mode, seed=11)
            try:
                host = {**r.ints(["id"]), **r.floats(["x"])}
                for c, name in ((0, "id"), (1, "x")):
                    idx = [r._block_idx(c, b) for b in range(r.blocks)]
                    payloads, tab = read_payloads(r.f, idx)
                    mins, bits = tab.mins, tab.bits
                    if name == "id":
                        dec = be.decode_int_blocks(payloads, mins, bits, m)
                        if not np.array_equal(dec.reshape(-1), host[name]):
                            raise AssertionError("sharded int decode differs "
                                                 "from the host reader")
                        out["id"] = dec
                        continue
                    low, high, pixels, per = tab.config
                    dec = be.decode_float_blocks(
                        payloads, mins, bits, low, high, pixels, m,
                        periodic=per, dither=mode, seed=11, block_ids=idx)
                    if not np.array_equal(dec.reshape(-1).view(np.uint32),
                                          host[name].view(np.uint32)):
                        raise AssertionError(
                            "sharded float decode differs from the host "
                            "reader in mode %s" % mode)
                    out["x " + mode] = dec
            finally:
                r.close()
    return out


def dryrun_minp_mesh(devices) -> bytes:
    """A minp vector file written through the several-device encoder,
    byte-compared with the host writer's, then read back within dx (ref
    go/minp/minp.go:86-119, 175-207).  Returns the file's bytes."""
    rng = np.random.default_rng(13)
    hd = minp.Header(l=100.0, n_side=8, n_total=512)
    vec = rng.uniform(0, 99.9, (512, 3)).astype(np.float32)
    with tempfile.TemporaryDirectory() as td:
        host_f = os.path.join(td, "host.minp")
        mesh_f = os.path.join(td, "mesh.minp")
        for fname, enc in ((host_f, None), (mesh_f, BlockEncoder(devices))):
            w = minp.Writer(fname, encoder=enc)
            w.header(hd, b"hdr", minp.Cell(0, 1, 2), 0.01, True)
            w.vectors(vec)
            w.close()
        mesh_bytes = _read(mesh_f)
        if mesh_bytes != _read(host_f):
            raise AssertionError("the several-device minp write differs "
                                 "from the host write")
        r = minp.open(mesh_f, dither="none")
        try:
            got = r.vectors()
        finally:
            r.close()
        if not np.abs(got - vec).max() <= 0.01 * (1 + 1e-4):
            raise AssertionError("minp round trip outside dx")
    return mesh_bytes


def dryrun_boundary_mesh(devices) -> bytes:
    """A boundary (ghost-cell) minh file written through the
    several-device encoder, byte-compared with the host per-cell loop
    (ref go/minh/boundary.go:184-225).  Returns the file's bytes."""
    rng = np.random.default_rng(21)
    l, cells, bnd = 100.0, 2, 5.0
    n = 300
    x = (rng.uniform(0, 1, n) * l).astype(np.float32)
    y = (rng.uniform(0, 1, n) * l).astype(np.float32)
    z = (rng.uniform(0, 1, n) * l).astype(np.float32)
    ids = rng.integers(0, 10 ** 12, n).astype(np.int64)

    def write(fname, enc):
        w = boundary.create_boundary(fname, encoder=enc)
        w.header("boundary mesh dryrun")
        w.geometry(l, bnd, cells)
        w.coordinates(x, y, z)
        w.column("id", minh.Column(type=minh.Int), ids)
        w.column("x", minh.Column(type=minh.Float, low=0, high=l, dx=0.001),
                 x)
        w.close()

    with tempfile.TemporaryDirectory() as td:
        host_f = os.path.join(td, "host.minh")
        mesh_f = os.path.join(td, "mesh.minh")
        write(host_f, None)
        write(mesh_f, BlockEncoder(devices))
        mesh_bytes = _read(mesh_f)
        if mesh_bytes != _read(host_f):
            raise AssertionError("the several-device boundary write differs "
                                 "from the host write")
    return mesh_bytes


def dryrun_ragged_buckets(devices):
    """48 ragged blocks whose widths fall into uneven buckets (at least
    one smaller than eight, the widest device list the tests take), and
    an int column above 32 bits, through the several-device encoder:
    byte for byte ``core.spec``'s blocks (ref go/minh/minh.go:99-139).
    Returns the float and the int blocks."""
    rng = np.random.default_rng(31)
    nb, nmax = 48, 1536
    lens = rng.integers(200, nmax + 1, nb).astype(np.int64)
    lens[3] = nmax
    pixels = spec.float_group_pixels(_LOW, _HIGH, _DX)
    x = np.zeros((nb, nmax), np.float32)
    # value spreads chosen so that the widths land in uneven buckets: a
    # few blocks nearly constant, some of middling spread, most full-range
    for i in range(nb):
        span = 0.01 if i % 16 == 0 else (1.0 if i % 5 == 0 else 249.9)
        x[i, :lens[i]] = rng.uniform(0, span, lens[i]).astype(np.float32)
    got = BlockEncoder(devices).encode_float_blocks(x, _LOW, _HIGH, pixels,
                                                    lens=lens)
    for i in range(nb):
        payload, mn, bits, _ = spec.encode_float_block(
            x[i, :lens[i]], _LOW, _HIGH, pixels)
        if (got.payloads[i], int(got.mins[i]), int(got.bits[i])) != (
                payload, mn, bits):
            raise AssertionError("ragged buckets: float block %d differs "
                                 "from spec" % i)
    widths, counts = np.unique(got.bits, return_counts=True)
    if len(widths) < 3 or counts.min() >= 8:
        raise AssertionError("the case degenerated: width buckets %s of %s "
                             "blocks" % (widths, counts))

    # an int column above 32 bits (ID-class widths of about 35, 39 and 43)
    iv = np.zeros((nb, nmax), np.int64)
    for i in range(nb):
        hi = 1 << (34 + (i % 3) * 4)
        iv[i, :lens[i]] = rng.integers(0, hi, lens[i])
    goti = BlockEncoder(devices).encode_int_blocks(iv, lens=lens)
    for i in range(nb):
        payload, mn, bits = spec.encode_int_block(iv[i, :lens[i]])
        if (goti.payloads[i], int(goti.mins[i]), int(goti.bits[i])) != (
                payload, mn, bits):
            raise AssertionError("ragged buckets: int block %d differs from "
                                 "spec" % i)
    if goti.bits.max() <= 32:
        raise AssertionError("the int column stayed within 32 bits")
    return got, goti


# every step by name, in the reference's order
STEPS = {"entry": entry,
         "production_writer": dryrun_production_writer,
         "pallas_shard": dryrun_pallas_shard,
         "sharded_decode": dryrun_sharded_decode,
         "minp_mesh": dryrun_minp_mesh,
         "boundary_mesh": dryrun_boundary_mesh,
         "ragged_buckets": dryrun_ragged_buckets}


def dryrun(devices=None) -> dict:
    """Every step on ``devices`` (a device or a list; default the CUDA
    device, an error without one).  Raises at the first difference;
    returns what each step produced, by name."""
    devices = BlockEncoder(devices).devices
    return {name: step(devices) for name, step in STEPS.items()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    devices = None
    for a in argv:
        key, _, val = a.partition("=")
        if key != "--devices" or not val:
            raise SystemExit(__doc__)
        devices = val.split(",")
    out = dryrun(devices)
    shown = BlockEncoder(devices).devices
    print("dryrun OK on %d device(s) %s: %s"
          % (len(shown), [str(d) for d in shown], ", ".join(
              "%s (%d bytes)" % (k, len(v)) if isinstance(v, bytes) else k
              for k, v in out.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
