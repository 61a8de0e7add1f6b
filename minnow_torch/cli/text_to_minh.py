"""text_to_minh: convert Rockstar/consistent-trees text halo catalogs to
minh (counterpart of ``minnow_tpu/cli/text_to_minh.py``; ref
scripts/text_to_minh.go -- the flagship encode pipeline).

Usage:
  python -m minnow_torch.cli.text_to_minh <config> <vars|all> <glob> <outdir>
        [--device] [--block-size=BYTES] [--jobs=N]

Config file (ref text_to_minh.go:80-109):

  [minh]
  L = 250            # box size, Mpc/h
  Epsilon = 1        # position precision
  Mp = 1.54975e+08   # particle mass
  MinParticles = 50  # mass cut: m > Mp*MinParticles
  MassName = mvir
  NameIndex = name_index.txt
  TypeIndex = type_index.txt

Type-index lines map canonical column names to storage types
(ref text_to_minh.go:223-269):

  <name> int64 | float32 | int
  <name> q_float position
  <name> q_float log|linear <min> <max> <eps>

Without ``--device`` the host codec (``core.spec``, numpy and the native
engine) writes the file.  With ``--device`` every Float and Int column of
a row-block is encoded on the CUDA device by the port's kernels
(``parallel.pipeline.BlockEncoder``, K1 and K3), and the output bytes are
identical; without a CUDA device ``--device`` is an error.  ``--jobs=N``
converts N files at once on host threads (:func:`convert_files`); with
``--device`` the jobs share one ``BlockEncoder``.
"""

from __future__ import annotations

import glob as globmod
import math
import os
import sys
import time

import numpy as np

from ..formats import minh
from ..ingest import rockstar
from ..utils import config as cfgmod
from ..utils import profiling
from ..utils import sched
from ..parallel.pipeline import BlockEncoder
from ..utils.device import cuda_device
from ..utils.name_index import open_index

__all__ = ["THREADS", "parse_config", "parse_types", "parse_vars",
           "column_from_type", "out_name", "convert_file", "convert_files",
           "main"]

# native-parse worker count.  The reference hard-codes 16 goroutines
# (ref text_to_minh.go:35), but std::threads oversubscribed past the
# core count measurably hurt (16 threads on a 4-core host: ~190 MB/s
# pipelined vs ~236 at 4 -- spawn cost + contention with the writer's
# encode pool), so cap at the machine.
THREADS = min(16, os.cpu_count() or 16)


def parse_config(fname: str):
    v = cfgmod.ConfigVars("minh")
    v.float("L", 0)
    v.float("Epsilon", 0)
    v.float("Mp", 0)
    v.int("MinParticles", 0)
    v.string("MassName", "mvir")
    v.string("NameIndex", "")
    v.string("TypeIndex", "")
    cfgmod.read_config(fname, v)
    for name in ("L", "Epsilon", "Mp", "MinParticles", "NameIndex",
                 "TypeIndex"):
        if not v[name]:
            raise SystemExit("%s not set in %s" % (name, fname))
    return v


def parse_types(fname: str, idx):
    """(ref text_to_minh.go:111-130)"""
    out = {}
    with open(fname) as f:
        for line in f.read().split("\n"):
            words = [w for w in line.strip().split(" ") if w]
            if not words:
                continue
            std, ok = idx.standardize(words[0])
            if not ok:
                raise SystemExit(
                    "Variable '%s' isn't contained in name index."
                    % words[0])
            out[std] = words[1:]
    return out


def parse_vars(fname: str, idx):
    """(ref text_to_minh.go:132-150)"""
    if fname == "all":
        toks = idx.all_names
    else:
        with open(fname) as f:
            toks = [t for t in f.read().split() if t]
    out = set()
    for v in toks:
        std, ok = idx.standardize(v)
        if not ok:
            raise SystemExit(
                "Variable '%s' isn't contained in name index." % v)
        out.add(std)
    return out


def column_from_type(cfg, t):
    """(ref text_to_minh.go:223-269) -> (Column, numpy dtype)"""
    kind = t[0]
    if kind == "int64":
        return minh.Column(type=minh.Int64), np.int64
    if kind == "float32":
        return minh.Column(type=minh.Float32), np.float32
    if kind == "int":
        return minh.Column(type=minh.Int), np.int64
    if kind == "q_float":
        col = minh.Column(type=minh.Float)
        if t[1] == "position":
            col.low, col.high, col.dx = 0.0, cfg["L"], cfg["Epsilon"]
        elif t[1] in ("log", "linear"):
            mn, mx, eps = float(t[2]), float(t[3]), float(t[4])
            if t[1] == "log":
                col.log = 1
                col.low, col.high = math.log10(mn), math.log10(mx)
            else:
                col.low, col.high = mn, mx
            col.dx = eps
        else:
            raise SystemExit("q_float qualifier %s not recognized" % t[1])
        return col, np.float32
    raise SystemExit("Type %s not recognized." % kind)


def out_name(out_dir: str, hlist: str) -> str:
    """(ref text_to_minh.go:69-78)"""
    base = os.path.basename(hlist)
    toks = base.split(".")
    toks = toks[:-1] + ["minh"] if len(toks) > 1 else [base, "minh"]
    return os.path.join(out_dir, ".".join(toks))


@profiling.traced("text_to_minh.convert_file")
def convert_file(cfg, idx, types, wanted, hlist, out, device=None,
                 threads=THREADS, timer=None, block_size=None, encoder=None):
    """(ref text_to_minh.go:166-214).  ``device`` is the torch device that
    encodes the Float and Int columns (a CUDA device runs the kernels,
    ``"cpu"`` their plain versions), or None for the host codec;
    ``encoder`` is a ``BlockEncoder`` to use in place of a new one on
    ``device`` (concurrent conversions share one).
    ``timer`` (optional
    utils.profiling.StageTimer) collects per-stage seconds/GBps:
    read / scan_lines / parse (inside the text reader, possibly on the
    prefetch thread), mass_cut, encode+write.  Every call also records
    its spans (``utils.profiling``), ``text_to_minh.convert_file`` the
    root.

    ``block_size`` caps the text-block size in bytes so parsing block
    b+1 overlaps encoding block b even within one file.  Default None =
    the reference's reader config (one row-block for files < 5 GiB,
    ref go/text/text.go:30-37); smaller blocks change the (equally
    valid) row-block structure of the output minh."""
    from ..ingest import text as text_mod

    config = None
    if block_size is not None:
        block_size = int(block_size)
        config = text_mod.ReaderConfig(
            max_block_size=block_size,
            max_item_size=min(
                text_mod.DEFAULT_READER_CONFIG.max_item_size,
                block_size // 2))
    fr = rockstar.open_rockstar(hlist, config)
    all_names = fr.names()
    header = fr.header()

    names, cols, dtypes = [], [], []
    std_all = []
    for raw in all_names:
        std, ok = idx.standardize(raw)
        std_all.append(std)
        if not ok:
            raise SystemExit("Column name '%s' from %s not in name index"
                             % (raw, hlist))
        if std not in wanted:
            continue
        col, dtype = column_from_type(cfg, types[std])
        names.append(std)
        cols.append(col)
        dtypes.append(dtype)

    cutoff = np.float32(cfg["Mp"] * cfg["MinParticles"])
    if cfg["MassName"] not in names:
        raise SystemExit("MassName '%s' not in name index."
                         % cfg["MassName"])

    fr.set_threads(threads)
    fr.set_names(std_all)
    if timer is not None:
        fr.set_timer(timer)

    if encoder is None and device is not None:
        encoder = BlockEncoder(device)
    # writer encode pool sized to this call's thread share (see
    # minh.Writer)
    fm = minh.create(out, encode_workers=min(4, max(1, threads)),
                     encoder=encoder)
    fm.header(names, header, cols)
    fm.geometry(np.float32(cfg["L"]), 0, 0)

    # parse/encode overlap: prefetch the next text block on a worker
    # thread while the current one quantizes/packs/writes (the pipelined
    # analog of the reference's sequential loop,
    # ref text_to_minh.go:208-212)
    from concurrent.futures import ThreadPoolExecutor

    n_blocks = fr.blocks()
    # the prefetch thread's spans have this call's as their parent
    block = profiling.carry(fr.block)
    # prefetch depth 1: exactly one text block parses ahead of the
    # encode.  Depth 2 was measured SLOWER on the 4-core host (two
    # 16-thread parses contend with the writer's 4 encode threads:
    # 231 vs 240 MB/s mean over 3 runs) -- don't deepen it again.
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(block, 0, names, dtypes)
        for b in range(n_blocks):
            # the main thread's wait names the device's idle gap in a
            # trace: the profiler sees no span of the prefetch thread
            with profiling.span("text_to_minh.parse_wait"):
                data = fut.result()
            with profiling.span("text_to_minh.mass_cut", 0, timer,
                                "mass_cut"):
                if b + 1 < n_blocks:
                    fut = pool.submit(block, b + 1, names, dtypes)
                mass = data[cfg["MassName"]]
                keep = mass > cutoff  # (ref text_to_minh.go:271-288)
                block_cols = ([data[n][keep] for n in names]
                              if keep.any() else None)
            if block_cols is not None:
                with profiling.span(
                        "text_to_minh.encode_write",
                        sum(c.nbytes for c in block_cols), timer,
                        "encode+write"):
                    fm.block(block_cols)
    fm.close()
    fr.close()


def convert_files(cfg, idx, types, wanted, files, out_dir,
                  device=None, block_size=None, jobs=1,
                  log=print) -> None:
    """Convert a list of catalog files, ``jobs`` of them concurrently
    (the reference's outer loop, ref scripts/text_to_minh.go:54-67,
    fanned out with utils/sched).  Each output file is independent so
    results are byte-identical to the sequential loop.  Biggest files
    start first so the queue tail stays balanced; per-file parse
    threads shrink so jobs x threads stays near the core count.  With a
    ``device`` the jobs share one ``BlockEncoder``."""
    # distinct inputs sharing a basename (a glob spanning directories)
    # would write the same output path -- concurrently with jobs > 1,
    # corrupting it silently; refuse up front
    outs = {}
    for f in files:
        o = out_name(out_dir, f)
        if o in outs:
            raise SystemExit(
                "input files %r and %r both map to output %r; "
                "convert them into separate output directories"
                % (outs[o], f, o))
        outs[o] = f

    jobs = max(1, min(jobs, len(files) or 1))
    per_threads = max(1, THREADS // jobs) if jobs > 1 else THREADS
    order = sorted(range(len(files)),
                   key=lambda i: -os.path.getsize(files[i]))
    encoder = None if device is None else BlockEncoder(device)

    def work(w, j):
        hlist = files[order[j]]
        log("Converting %s" % hlist)
        t0 = time.time()
        convert_file(cfg, idx, types, wanted, hlist,
                     out_name(out_dir, hlist), threads=per_threads,
                     block_size=block_size, encoder=encoder)
        log("    %s: %.2f minutes" % (os.path.basename(hlist),
                                      (time.time() - t0) / 60))

    sched.worker_queue(jobs, len(files), work)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        argv.remove("--device")
        device = cuda_device()
    block_size = None
    jobs = 1
    for a in list(argv):
        if a.startswith("--block-size="):
            block_size = int(a.split("=", 1)[1])
            argv.remove(a)
        elif a.startswith("--jobs="):
            jobs = int(a.split("=", 1)[1])
            argv.remove(a)
    if len(argv) != 4:
        raise SystemExit(__doc__)
    config_fname, vars_fname, in_pattern, out_dir = argv

    cfg = parse_config(config_fname)
    idx = open_index(cfg["NameIndex"])
    types = parse_types(cfg["TypeIndex"], idx)
    wanted = parse_vars(vars_fname, idx)

    convert_files(cfg, idx, types, wanted,
                  sorted(globmod.glob(in_pattern)), out_dir,
                  device=device, block_size=block_size, jobs=jobs)


if __name__ == "__main__":
    main()
