"""Particle snapshots (minp) as their users run them through the port.

``convert``: ``convert_snapshot.to_minp`` of the set-up's LGadget-2
fileset on the device, into a new directory a request.  ``read``: open
one file of the set-up's fileset (positions and velocities in turn),
``minp_device.read_vectors`` it and wait for the card.  The read's files
are written in set-up by the port's minp writer with its device encoder,
from vectors already in Lagrangian order.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from minnow_torch.cli import convert_snapshot
from minnow_torch.formats import minp, minp_device
from minnow_torch.ingest import snapshot as snap_mod
from minnow_torch.parallel.pipeline import BlockEncoder

from harness import roofline
from harness.cell import sync
from harness.compare import differing, file_bytes
from harness.faults import FILES, VALUES, on_output, on_result
from reference import codec, container
from reference import minp as ref
from traffic import snapshot


class Workload:
    def __init__(self, cfg, mix, seed, device, workdir, spans):
        self.cfg, self.kind, self.seed = cfg, mix["kind"], seed
        self.device, self.workdir, self.spans = device, workdir, spans
        self.sites = ref.cell_sites(cfg["n_side"], cfg["file_cells"], 0)

    def _hd(self) -> dict:
        c = self.cfg
        n = c["n_side"] ** 3
        return {"l": c["L"], "n_side": c["n_side"], "n_total": n,
                "omega_m": c["cosmology"]["omega_m"]}

    def _write(self, directory, x, v, encoder) -> list:
        """Write file cell 0's positions and velocities with the port's
        minp writer; returns the two paths."""
        c = self.cfg
        hd = minp.Header(z=0.0, scale=1.0, l=c["L"], n_side=c["n_side"],
                         n_total=c["n_side"] ** 3,
                         omega_m=c["cosmology"]["omega_m"],
                         omega_l=c["cosmology"]["omega_l"],
                         h100=c["cosmology"]["h100"])
        snap_mod.calc_uniform_mass(hd)
        raw = snapshot.gadget_header(c, len(self.sites), 1)
        cell = minp.Cell(0, c["file_cells"], c["sub_cells"])
        paths = []
        for name, vec, step, periodic in (("x_0.minp", x, c["dx"], True),
                                          ("v_0.minp", v, c["dv"], False)):
            path = os.path.join(directory, name)
            w = minp.Writer(path, encoder=encoder)
            w.header(hd, raw, cell, step, periodic)
            w.vectors(vec[self.sites])
            w.close()
            paths.append(path)
        return paths

    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        c = self.cfg
        self.x, self.v = snapshot.make(c, self.seed)
        self.out = os.path.join(self.workdir, "out")
        os.makedirs(self.out)
        if self.kind == "convert":
            self.gadget = os.path.join(self.workdir, "gadget")
            os.makedirs(self.gadget)
            snapshot.write_gadget(self.gadget, c, self.x, self.v, self.seed)
            self.x = self.v = None
            self.values = 6 * c["n_side"] ** 3
            # one conversion before the window, as each in it
            warm = self._convert("warm")
            paths = [os.path.join(warm, n) for n in ("x_0.minp", "v_0.minp")]
        else:
            warm = os.path.join(self.workdir, "files")
            os.makedirs(warm)
            self.paths = paths = self._write(warm, self.x, self.v,
                                             BlockEncoder(self.device))
        blocks = []
        for path in paths:
            with open(path, "rb") as f:
                blocks += container.block_table(f.read())
        coded = [(n, bits, 4) for _, n, bits in blocks]
        # a read request is one of the two files
        self.kernel_bytes = {"encode": roofline.encode_bytes(coded),
                             "decode": roofline.decode_bytes(coded) // 2}
        if self.kind == "convert":
            # a conversion writes every file cell; cell 0's bytes stand
            # for each one's
            self.kernel_bytes["encode"] *= c["file_cells"] ** 3
            shutil.rmtree(warm)
        else:
            self.values = 3 * len(self.sites)
            for i in range(4):
                self._read(i)

    def _convert(self, name: str) -> str:
        c = self.cfg
        out = os.path.join(self.out, name)
        os.makedirs(out)
        convert_snapshot.to_minp(self.gadget, out, c["file_cells"],
                                 c["sub_cells"], c["dx"], c["dv"],
                                 self.device)
        return out

    def _read(self, i: int):
        with self.spans.span("open"):
            r = minp.Reader(self.paths[i % 2], dither=self.cfg["dither"],
                            seed=self.cfg["dither_seed"])
        try:
            with self.spans.span("read_call"):
                out = minp_device.read_vectors(r, self.device)
                sync(self.device)
        finally:
            r.close()
        return out

    # -- the window --------------------------------------------------------

    def request(self, i: int):
        if self.kind == "read":
            return self.values, self._read(i)
        with self.spans.span("convert"):
            out = self._convert(str(i))
        return self.values, out

    def drop(self, out) -> None:
        if self.kind == "convert":
            shutil.rmtree(out, ignore_errors=True)

    def release(self) -> None:
        pass

    # -- the check ---------------------------------------------------------

    def _reference(self, lower=None) -> dict:
        c = self.cfg
        if self.kind == "convert":
            hd, raws, x, v = ref.rebin(self.gadget, lower)
            return ref.fileset(x, v, hd, raws, c["file_cells"],
                               c["sub_cells"], c["dx"], c["dv"])
        x, v = self.x, self.v
        if lower is not None:
            x, v = lower(x), lower(v)
        hd, raw = self._hd(), b""
        return {"x_0.minp": ref.CellFile(x[self.sites], hd, raw, 0,
                                         c["file_cells"], c["sub_cells"],
                                         c["dx"], True),
                "v_0.minp": ref.CellFile(v[self.sites], hd, raw, 0,
                                         c["file_cells"], c["sub_cells"],
                                         c["dv"], False)}

    def check(self, kept) -> dict:
        """The numbers compared, each ``[value, limit]``: bytes of the
        kept filesets that differ from the reference's files (a missing or
        surplus byte counts), or decoded values that differ bitwise."""
        files = self._reference()
        unchecked = [0 if kept else 1, 0]
        if self.kind == "convert":
            bad = 0
            for name, cf in files.items():
                want = np.frombuffer(cf.file_bytes(), np.uint8)
                bad += sum(differing(file_bytes(os.path.join(out, name)),
                                     want) for _, out in kept)
            surplus = sum(len(set(os.listdir(out)) - set(files))
                          for _, out in kept)
            return {"bytes_differing": [bad, 0],
                    "files_surplus": [surplus, 0],
                    "outputs_unchecked": unchecked}
        seed = self.cfg["dither_seed"]
        want = [files["x_0.minp"].decoded(seed),
                files["v_0.minp"].decoded(seed)]
        bad = sum(differing(got, want[i % 2]) for i, got in kept)
        return {"values_differing": [bad, 0], "outputs_unchecked": unchecked}

    def control(self) -> list:
        """The reference in the program's place, in bfloat16: outputs as
        the window keeps them."""
        files = self._reference(codec.bfloat16)
        if self.kind == "read":
            seed = self.cfg["dither_seed"]
            return [(0, files["x_0.minp"].decoded(seed)),
                    (1, files["v_0.minp"].decoded(seed))]
        out = os.path.join(self.out, "control")
        os.makedirs(out)
        for name, cf in files.items():
            with open(os.path.join(out, name), "wb") as f:
                f.write(cf.file_bytes())
        return [(0, out)]



# -- the benchmark's tests --------------------------------------------------


def small(cfg) -> dict:
    """The overrides that run a configuration of this format in seconds
    on the CPU."""
    return {"n_side": 32}


def _timed_output(args):
    out_dir = args[1]  # to_minp(in_dir, out_dir, ...)
    if os.path.basename(out_dir).isdigit():  # a request's: its number
        return os.path.join(out_dir, "x_0.minp")
    return None


def faults(kind) -> dict:
    """Fault name -> ``plant(monkeypatch)``, which breaks this format's
    timed entry point for ``kind`` traffic: the vectors that
    ``read_vectors`` returns, or a file of the fileset that ``to_minp``
    writes for a request (set-up's own conversion stays sound)."""
    if kind == "read":
        return {n: on_result(minp_device, "read_vectors", f)
                for n, f in VALUES.items()}
    if kind == "convert":
        return {n: on_output(convert_snapshot, "to_minp", _timed_output, f)
                for n, f in FILES.items()}
    raise KeyError("formats/minp.py serves no %r traffic" % kind)
