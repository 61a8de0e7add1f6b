"""Halo catalogs (minh) as their users run them through the port.

``convert``: ``text_to_minh.convert_file`` of the set-up's catalog (a
consistent-trees hlist of 60 columns, 11 of them kept, as the
configuration's ``types`` list them) with a ``BlockEncoder`` on the
device and a ``StageTimer``, into a new file a request.  ``read``: open the set-up's minh file and read every column:
the ``Float`` columns by ``read_floats``, the ``Int`` columns by
``read_ints``, the raw ones by the host reader, as a catalog is loaded.
"""

from __future__ import annotations

import os

import numpy as np

from minnow_torch.cli import text_to_minh
from minnow_torch.formats import minh, minh_device
from minnow_torch.parallel.pipeline import BlockEncoder
from minnow_torch.utils.name_index import open_index
from minnow_torch.utils.profiling import StageTimer

from harness import roofline
from harness.cell import inputs_made
from harness.compare import differing, file_bytes
from harness.faults import FILES, VALUES, on_output, on_result
from reference import codec, container
from reference import minh as ref
from traffic import catalog

VALUE_BYTES = {container.FLOAT_GROUP: 4, container.INT_GROUP: 8}


class Workload:
    def __init__(self, cfg, mix, seed, device, workdir, spans):
        self.cfg, self.kind, self.seed = cfg, mix["kind"], seed
        self.device, self.workdir, self.spans = device, workdir, spans
        self.timer = StageTimer()

    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        inputs = os.path.join(self.workdir, "inputs")
        self.out = os.path.join(self.workdir, "out")
        os.makedirs(inputs)
        os.makedirs(self.out)
        self.hlist = catalog.write(inputs, self.cfg, self.seed, self.device)
        inputs_made(self.device)
        pcfg = text_to_minh.parse_config(os.path.join(inputs, "run.config"))
        idx = open_index(pcfg["NameIndex"])
        self.args = (pcfg, idx, text_to_minh.parse_types(pcfg["TypeIndex"],
                                                          idx),
                     text_to_minh.parse_vars(
                         os.path.join(inputs, "vars.txt"), idx))
        self.encoder = BlockEncoder(self.device)
        self.path = os.path.join(self.workdir, "catalog.minh")
        for _ in range(2):
            self._convert(self.path, StageTimer())
        with open(self.path, "rb") as f:
            blocks = container.block_table(f.read())
        self.values = sum(n for _, n, _ in blocks)
        coded = [(n, bits, VALUE_BYTES[t]) for t, n, bits in blocks
                 if bits is not None]
        self.kernel_bytes = {"encode": roofline.encode_bytes(coded),
                             "decode": roofline.decode_bytes(coded)}
        types = self.cfg["types"]
        self.floats = [n for n, t in types.items() if t[0] == "q_float"]
        self.ints = [n for n, t in types.items() if t[0] == "int"]
        self.raw = [n for n, t in types.items()
                    if t[0] not in ("q_float", "int")]
        if self.kind == "read":
            for _ in range(2):
                self._read()

    def _convert(self, out: str, timer) -> None:
        text_to_minh.convert_file(*self.args, self.hlist, out,
                                  timer=timer, encoder=self.encoder)

    def _read(self) -> dict:
        with self.spans.span("open"):
            r = minh.Reader(self.path, dither=self.cfg["dither"],
                            seed=self.cfg["dither_seed"])
        try:
            with self.spans.span("read_call"):
                out = minh_device.read_floats(r, self.floats, self.device)
                out.update(minh_device.read_ints(r, self.ints, self.device))
                out.update(r.ints(self.raw))
        finally:
            r.close()
        return out

    # -- the window --------------------------------------------------------

    def request(self, i: int):
        if self.kind == "read":
            return self.values, self._read()
        out = os.path.join(self.out, "%d.minh" % i)
        with self.spans.span("convert"):
            self._convert(out, self.timer)
        return self.values, out

    def drop(self, out) -> None:
        if self.kind == "convert" and os.path.exists(out):
            os.remove(out)

    def release(self) -> None:
        self.encoder = None

    # -- the check ---------------------------------------------------------

    def check(self, kept) -> dict:
        """The numbers compared, each ``[value, limit]``: bytes of the
        kept files that differ from the reference's file (a missing or
        surplus byte counts), or decoded values that differ bitwise."""
        cat = ref.Catalog(self.hlist, self.cfg)
        if self.kind == "convert":
            want = np.frombuffer(cat.file_bytes(), np.uint8)
            bad = sum(differing(file_bytes(out), want) for _, out in kept)
            return {"bytes_differing": [bad, 0],
                    "outputs_unchecked": [0 if kept else 1, 0]}
        want = cat.decoded(self.cfg["dither_seed"])
        bad = sum(differing(got.get(n), want[n]) for _, got in kept
                  for n in want)
        return {"values_differing": [bad, 0],
                "outputs_unchecked": [0 if kept else 1, 0]}

    def control(self) -> list:
        """The reference in the program's place, its float columns in
        bfloat16: outputs as the window keeps them."""
        cat = ref.Catalog(self.hlist, self.cfg, lower=codec.bfloat16)
        if self.kind == "read":
            return [(0, cat.decoded(self.cfg["dither_seed"]))]
        out = os.path.join(self.out, "control.minh")
        with open(out, "wb") as f:
            f.write(cat.file_bytes())
        return [(0, out)]



# -- the benchmark's tests --------------------------------------------------


def small(cfg) -> dict:
    """The overrides that run a configuration of this format in seconds
    on the CPU."""
    return {"rows": 1500}


def _each(fault):
    return lambda out: {n: fault(a) for n, a in out.items()}


def _timed_output(args):
    out = args[5]  # convert_file(config, index, types, vars, hlist, out)
    return out if os.path.basename(os.path.dirname(out)) == "out" else None


def faults(kind) -> dict:
    """Fault name -> ``plant(monkeypatch)``, which breaks this format's
    timed entry point for ``kind`` traffic: the float columns that
    ``read_floats`` returns, or the file that ``convert_file`` writes for
    a request (set-up's own conversions stay sound)."""
    if kind == "read":
        return {n: on_result(minh_device, "read_floats", _each(f))
                for n, f in VALUES.items()}
    if kind == "convert":
        return {n: on_output(text_to_minh, "convert_file", _timed_output, f)
                for n, f in FILES.items()}
    raise KeyError("formats/minh.py serves no %r traffic" % kind)
