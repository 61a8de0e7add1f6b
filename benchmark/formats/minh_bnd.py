"""Halo catalogs laid out in spatial cells (minh boundary files) as their
users make them through the port.

``convert``: ``minh_to_bnd.convert_file`` of the set-up's basic minh
catalog on the device, called as ``minh_to_bnd.main`` calls it (its
Float and Int columns read by K2 and K4, every cell group of them
encoded by K1 and K3 through the call's own ``BlockEncoder``) into
``cells^3`` cells with ghost shells of width ``boundary``, into a new
file a request.

The input is the reference's own minh file of a consistent-trees hlist
printed from the seed, so it does not depend on the program; the hlist
is deleted once the reference has parsed it.  The program reads its
input with the reader's default dither seed, 0, which the
configuration's ``dither_seed`` states.  Set-up keeps of the reference
only its decode and its cells' lengths, which count a request's values;
the reference's boundary file is built in ``check``, outside
``setup_s``.
"""

from __future__ import annotations

import os

import numpy as np

from minnow_torch.cli import minh_to_bnd

from harness import roofline
from harness.cell import inputs_made
from harness.compare import differing, file_bytes
from harness.faults import FILES, on_output
from reference import boundary, codec, container
from reference import minh as ref
from traffic import catalog

VALUE_BYTES = {container.FLOAT_GROUP: 4, container.INT_GROUP: 8}
# the columns a request reads twice: for the cells and as columns
POSITIONS = ("x", "y", "z")


def _coded(blocks) -> list:
    """``(n, bits, value bytes)`` of the coded blocks of a block table."""
    return [(n, bits, VALUE_BYTES[t]) for t, n, bits in blocks
            if bits is not None]


class Workload:
    def __init__(self, cfg, mix, seed, device, workdir, spans):
        self.cfg, self.seed = cfg, seed
        self.device, self.workdir, self.spans = device, workdir, spans

    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        c = self.cfg
        inputs = os.path.join(self.workdir, "inputs")
        self.out = os.path.join(self.workdir, "out")
        os.makedirs(inputs)
        os.makedirs(self.out)
        hlist = catalog.write(inputs, c, self.seed, self.device)
        self.cat = ref.Catalog(hlist, c)
        self.src = os.path.join(self.workdir, "catalog.minh")
        with open(self.src, "wb") as f:
            f.write(self.cat.file_bytes())
        inputs_made(self.device)
        os.remove(hlist)
        self.decoded = self.cat.decoded(c["dither_seed"])
        # the rows the reference lays out, in the flag column and in each
        # of the catalog's; the reference's file is built in check()
        lay = boundary.Layout(*(self.decoded[n] for n in POSITIONS),
                              self.cat.box, c["boundary"], c["cells"])
        self.values = (1 + len(self.cat.names)) * sum(lay.lengths)
        for i in range(2):
            self._convert(os.path.join(self.workdir, "warm%d.bnd.minh" % i))

    def _convert(self, out: str) -> None:
        c = self.cfg
        minh_to_bnd.convert_file(self.src, out, c["cells"], c["boundary"],
                                 device=self.device, dither=c["dither"])

    # -- the window --------------------------------------------------------

    def request(self, i: int):
        out = os.path.join(self.out, "%d.bnd.minh" % i)
        with self.spans.span("convert"):
            self._convert(out)
        return self.values, out

    def drop(self, out) -> None:
        if os.path.exists(out):
            os.remove(out)

    def release(self) -> None:
        pass

    # -- the check ---------------------------------------------------------

    def check(self, kept) -> dict:
        """The numbers compared, each ``[value, limit]``: bytes of the
        kept files that differ from the reference's file (a missing or
        surplus byte counts).  Also sets ``kernel_bytes`` from the
        reference's file and the input's block table."""
        c = self.cfg
        want = boundary.file_bytes(self.cat, self.decoded, c["cells"],
                                   c["boundary"])
        with open(self.src, "rb") as f:
            source = container.block_table(f.read())
        # one row-block: the input's block i is its column i
        reads = [b for name, b in zip(self.cat.names, source)
                 for _ in range(2 if name in POSITIONS else 1)]
        # the flag column's groups, the first cells^3, are encoded on the
        # host
        self.kernel_bytes = {
            "encode": roofline.encode_bytes(
                _coded(container.block_table(want)[c["cells"] ** 3:])),
            "decode": roofline.decode_bytes(_coded(reads))}
        want = np.frombuffer(want, np.uint8)
        bad = sum(differing(file_bytes(out), want) for _, out in kept)
        return {"bytes_differing": [bad, 0],
                "outputs_unchecked": [0 if kept else 1, 0]}

    def control(self) -> list:
        """The reference in the program's place, the float columns it
        reads in bfloat16: outputs as the window keeps them."""
        lowered = {n: codec.bfloat16(self.decoded[n])
                   if col.type == ref.FLOAT else self.decoded[n]
                   for n, col in zip(self.cat.names, self.cat.cols)}
        out = os.path.join(self.out, "control.bnd.minh")
        with open(out, "wb") as f:
            f.write(boundary.file_bytes(self.cat, lowered, self.cfg["cells"],
                                        self.cfg["boundary"]))
        return [(0, out)]


# -- the benchmark's tests --------------------------------------------------


def small(cfg) -> dict:
    """The overrides that run a configuration of this format in seconds
    on the CPU: at 8^3 cells some cells are empty and some halos lie in
    8 cells."""
    return {"rows": 2000}


def _timed_output(args):
    out = args[1]  # convert_file(in_name, out_name, cells, boundary, ...)
    return out if os.path.basename(os.path.dirname(out)) == "out" else None


def faults(kind) -> dict:
    """Fault name -> ``plant(monkeypatch)``, which breaks the file that
    ``convert_file`` writes for a request (set-up's own conversions stay
    sound)."""
    if kind == "convert":
        return {n: on_output(minh_to_bnd, "convert_file", _timed_output, f)
                for n, f in FILES.items()}
    raise KeyError("formats/minh_bnd.py serves no %r traffic" % kind)
