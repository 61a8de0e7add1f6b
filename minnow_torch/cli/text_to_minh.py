"""text_to_minh: convert Rockstar/consistent-trees text halo catalogs to
minh, with the float and int columns encoded on a CUDA device
(counterpart of ``minnow_tpu/cli/text_to_minh.py``; ref
scripts/text_to_minh.go).

Usage:
  python -m minnow_torch.cli.text_to_minh <config> <vars|all> <glob> <outdir>
        [--device] [--block-size=BYTES]

The config, type-index and name-index files are those of the reference
converter.  With ``--device`` every Float and Int column of a row-block
is encoded on the CUDA device by the port's kernels, and the output
bytes equal the host codec's; without a CUDA device ``--device`` is an
error.  Without it the host codec writes the file.
"""

from __future__ import annotations

import glob as globmod
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# the reference converter's host parts, jax-free; its _DeviceMinhWriter
# only calls the encoder it is given, here the port's BlockEncoder
from minnow_tpu.cli.text_to_minh import (THREADS, _DeviceMinhWriter,
                                         column_from_type, out_name,
                                         parse_config, parse_types,
                                         parse_vars)
from minnow_tpu.formats import minh
from minnow_tpu.ingest import rockstar
from minnow_tpu.utils.name_index import open_index

from ..parallel.pipeline import BlockEncoder
from ..utils.device import cuda_device

__all__ = ["convert_file", "main"]


def convert_file(cfg, idx, types, wanted, hlist, out, device,
                 threads=THREADS, block_size=None, timer=None):
    """Convert one catalog file (ref text_to_minh.go:166-214).

    ``device`` is the torch device that encodes the Float and Int
    columns (a CUDA device runs the kernels, ``"cpu"`` their plain
    versions), or None for the host codec.  ``timer``, when given, is a
    dict that collects seconds per stage: ``parse_wait``, ``mass_cut``,
    ``encode+write`` and ``finalize``."""
    from minnow_tpu.ingest import text as text_mod

    config = None
    if block_size is not None:
        block_size = int(block_size)
        config = text_mod.ReaderConfig(
            max_block_size=block_size,
            max_item_size=min(text_mod.DEFAULT_READER_CONFIG.max_item_size,
                              block_size // 2))
    fr = rockstar.open_rockstar(hlist, config)
    header = fr.header()

    names, cols, dtypes, std_all = [], [], [], []
    for raw in fr.names():
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

    fm = minh.create(out, encode_workers=min(4, max(1, threads)))
    if device is not None:
        fm = _DeviceMinhWriter(fm, BlockEncoder(device))
    fm.header(names, header, cols)
    fm.geometry(np.float32(cfg["L"]), 0, 0)

    def add(stage, seconds):
        if timer is not None:
            timer[stage] = timer.get(stage, 0.0) + seconds

    # parse the next text block on a worker thread while this one is
    # encoded and written (prefetch depth 1, as the reference converter)
    n_blocks = fr.blocks()
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(fr.block, 0, names, dtypes)
        for b in range(n_blocks):
            t0 = time.perf_counter()
            data = fut.result()
            t1 = time.perf_counter()
            if b + 1 < n_blocks:
                fut = pool.submit(fr.block, b + 1, names, dtypes)
            keep = data[cfg["MassName"]] > cutoff  # ref :271-288
            if keep.any():
                block_cols = [data[n][keep] for n in names]
                t2 = time.perf_counter()
                fm.block(block_cols)
                add("parse_wait", t1 - t0)
                add("mass_cut", t2 - t1)
                add("encode+write", time.perf_counter() - t2)
    t0 = time.perf_counter()
    fm.close()
    fr.close()
    add("finalize", time.perf_counter() - t0)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        argv.remove("--device")
        device = cuda_device()
    block_size = None
    for a in list(argv):
        if a.startswith("--block-size="):
            block_size = int(a.split("=", 1)[1])
            argv.remove(a)
    if len(argv) != 4:
        raise SystemExit(__doc__)
    config_fname, vars_fname, in_pattern, out_dir = argv

    cfg = parse_config(config_fname)
    idx = open_index(cfg["NameIndex"])
    types = parse_types(cfg["TypeIndex"], idx)
    wanted = parse_vars(vars_fname, idx)

    for hlist in sorted(globmod.glob(in_pattern)):
        print("Converting %s" % hlist)
        t0 = time.time()
        convert_file(cfg, idx, types, wanted, hlist,
                     out_name(out_dir, hlist), device,
                     block_size=block_size)
        print("    %s: %.2f minutes" % (os.path.basename(hlist),
                                        (time.time() - t0) / 60))


if __name__ == "__main__":
    main()
