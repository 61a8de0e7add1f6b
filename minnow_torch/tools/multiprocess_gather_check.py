"""Multi-process check of ``parallel.distributed.gather_blocks`` and of
the sharded read-back (counterpart of
``tools/multiprocess_gather_check.py``).

    python3 -m minnow_torch.tools.multiprocess_gather_check [--procs=N]
        [--mode={auto,gather,allgather}] [--device={cuda,cpu}] [--rows=R]

N worker processes (default 4) join one gloo group on a free local port.
Each builds the same catalog from a seed: 11 ragged row-blocks of an
``int`` ID column (IDs from 2^53 + 1 whose high bits cycle, so every
block is wider than 32 bits), a periodic position column (L = 250,
epsilon = 0.001) and a log mass column.  The row-blocks are dealt to the
processes contiguously in *unequal* counts (``mesh.block_shards``).
Every process encodes the columns of its own row-blocks with
``BlockEncoder`` on its device, the shares are gathered with
``gather_blocks``, and process 0 writes a complete **minh** file from the
gathered streams, which must be byte-identical to a plain single-process
host write of the whole catalog (the ordered multi-process writer
contract, process-major global block order, ref
go/block_index.go:16-23).  After a barrier every process decodes its own
row-blocks from the shared file -- the payloads of its int blocks and of
its float blocks each from one read of their span -- with
``decode_int_blocks`` and ``decode_float_blocks``, one call of each a
row-block, and compares them bitwise with the host reader.

``--rows`` scales the 563-row catalog (a multiple of 563; default 563).
``--device=cuda`` (the default) puts every worker on the CUDA device,
``--device=cpu`` on the CPU, where the kernels' plain versions run.  A
worker that fails or outlives ``--timeout`` seconds (default 300) fails
the run, and the other workers are stopped.  The last line of output is
one JSON object: sizes, seconds per stage and rank (host clock, after a
device synchronize; ``wait`` is a barrier before the gather, so that
``gather`` holds no wait for the slowest encoder; ``read_back`` is the
device decode of the rank's row-blocks, its reads included,
``host_reader`` the host reader's decode of the same), and each rank's
kernel launches on the path and in its read-back.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# global row-blocks (ragged sizes), dealt process-major and contiguous
# (gather_blocks returns process-major order, so ownership must be a
# contiguous split for gathered index == global block index);
# 11 blocks keep the per-process counts UNEQUAL for 2/3/4/8 processes
BLOCK_SIZES = [61, 48, 64, 33, 57, 29, 71, 44, 52, 38, 66]
BASE_ROWS = sum(BLOCK_SIZES)
L, EPS = 250.0, 0.001
MVIR_LO, MVIR_HI, MVIR_EPS = 1e9, 1e15, 0.001
ID0 = (1 << 53) + 1
TEXT = "multiprocess gather check"


def block_sizes(rows: int) -> list:
    if rows < BASE_ROWS or rows % BASE_ROWS:
        raise SystemExit("--rows must be a multiple of %d, got %d"
                         % (BASE_ROWS, rows))
    return [n * (rows // BASE_ROWS) for n in BLOCK_SIZES]


def owner_counts(num_procs: int) -> list:
    """Row-blocks of each process: the contiguous split of
    ``mesh.block_shards``, earlier processes taking the remainder --
    always UNEQUAL counts for 2, 3, 4 and 8 processes."""
    from minnow_torch.parallel.mesh import block_shards

    return [s.stop - s.start
            for s in block_shards(len(BLOCK_SIZES), num_procs)]


def make_catalog(rows: int = BASE_ROWS):
    """The row-blocks ``(ids, x, mvir)`` of the catalog, from a seed."""
    rng = np.random.default_rng(7)
    blocks = []
    base = 0
    for n in block_sizes(rows):
        i = np.arange(n, dtype=np.int64) + base
        # a tree-style ID: a forest number in the bits from 34 up, so a
        # block of 7 rows or more spans 37 bits
        ids = ID0 + ((i % 7) << 34) + i * 13
        x = rng.uniform(0, L - 0.1, n).astype(np.float32)
        mvir = (10.0 ** rng.uniform(np.log10(MVIR_LO) + 0.01,
                                    np.log10(MVIR_HI) - 0.01, n)
                ).astype(np.float32)
        blocks.append((ids, x, mvir))
        base += n
    return blocks


def minh_cols():
    from minnow_torch.formats import minh

    return ["id", "x", "mvir"], [
        minh.Column(type=minh.Int),
        minh.Column(type=minh.Float, low=0.0, high=L, dx=EPS),
        minh.Column(type=minh.Float, log=1, low=float(np.log10(MVIR_LO)),
                    high=float(np.log10(MVIR_HI)), dx=MVIR_EPS),
    ]


def write_host_minh(path, blocks):
    """Plain single-process reference write with the host codec."""
    from minnow_torch.formats import minh

    names, cols = minh_cols()
    w = minh.create(path)
    w.header(names, TEXT, cols)
    w.geometry(L, 0, 0)
    for ids, x, mvir in blocks:
        w.block([ids, x, mvir])
    w.close()


FLOAT_COLS = [1, 2]  # x, mvir


def rank_batches(blocks, mine):
    """The batches a process encodes for its row-blocks ``mine``: the
    int column as ``(ib, ilens)``, one block per row-block, and the float
    columns as ``(fb, flens, flow, fhigh, fpix)``, flattened (row-block,
    column) process-major; rows ragged, zeros beyond each length, all as
    wide as the catalog's longest row-block."""
    from minnow_torch.core import spec
    from minnow_torch.formats import minh

    _, cols = minh_cols()
    n_max = max(len(b[0]) for b in blocks)
    ib = np.zeros((len(mine), n_max), np.int64)
    ilens = np.zeros(len(mine), np.int64)
    for r, g in enumerate(mine):
        ids = blocks[g][0]
        ib[r, :len(ids)] = ids
        ilens[r] = len(ids)
    nf = len(mine) * len(FLOAT_COLS)
    fb = np.zeros((nf, n_max), np.float32)
    flens = np.zeros(nf, np.int64)
    flow = np.zeros(nf, np.float32)
    fhigh = np.zeros(nf, np.float32)
    fpix = np.ones(nf, np.int64)
    k = 0
    for g in mine:
        for c in FLOAT_COLS:
            col = cols[c]
            data = minh.process_float_column(blocks[g][c], col)
            fb[k, :len(data)] = data
            flens[k] = len(data)
            flow[k] = col.low
            fhigh[k] = col.high
            fpix[k] = spec.float_group_pixels(col.low, col.high, col.dx)
            k += 1
    return ib, ilens, fb, flens, flow, fhigh, fpix


def worker(rank: int, num: int, port: int, out_file: str, mode: str,
           device: str, rows: int) -> None:
    import torch

    from minnow_torch.formats import minh
    from minnow_torch.formats.device_common import read_payloads
    from minnow_torch.ops import decode, encode, selfcheck
    from minnow_torch.parallel import distributed
    from minnow_torch.parallel.pipeline import BlockEncoder
    from minnow_torch.utils.device import cuda_device

    distributed.init_distributed(init_method="tcp://localhost:%d" % port,
                                 world_size=num, rank=rank)
    dev = cuda_device() if device == "cuda" else torch.device("cpu")
    on_card = dev.type == "cuda"

    def clock():
        if on_card:
            torch.cuda.synchronize()
        return time.perf_counter()

    blocks = make_catalog(rows)
    sizes = [len(b[0]) for b in blocks]
    names, cols = minh_cols()
    counts = owner_counts(num)
    first = sum(counts[:rank])
    mine = list(range(first, first + counts[rank]))
    gmode = None if mode == "auto" else mode
    be = BlockEncoder(dev)
    t = {}

    # the one-shot certification of each kernel family is not part of the
    # path: run it first, then count launches from zero
    t0 = clock()
    if on_card:
        for family in selfcheck.FAMILIES:
            selfcheck.kernel_ok(family, dev)
    t["certify"] = clock() - t0
    encode.K1_LAUNCHES = encode.K3_LAUNCHES = encode.K5_LAUNCHES = 0
    encode.K3_STATS_LAUNCHES = encode.K3_PLAN_LAUNCHES = 0
    decode.K2_LAUNCHES = decode.K4_LAUNCHES = 0

    t0 = clock()
    ib, ilens, fb, flens, flow, fhigh, fpix = rank_batches(blocks, mine)
    local_i = be.encode_int_blocks(ib, lens=ilens)
    local_f = be.encode_float_blocks(fb, flow, fhigh, fpix, lens=flens)
    t["encode"] = clock() - t0

    # the gather's own time: not the wait for the slowest encoder
    t0 = clock()
    distributed.barrier()
    t["wait"] = clock() - t0
    t0 = clock()
    enc_i = distributed.gather_blocks(local_i, mode=gmode)
    enc_f = distributed.gather_blocks(local_f, mode=gmode)
    t["gather"] = clock() - t0
    sent = local_i.total_bytes() + local_f.total_bytes()
    on_every_rank = mode == "allgather" or (mode == "auto" and num <= 4)
    if num > 1 and rank != 0 and (enc_i is None) == on_every_rank:
        raise AssertionError("gather_blocks(mode=%s) returned %s on rank %d"
                             % (mode, type(enc_i).__name__, rank))

    mp_file = out_file + ".minh"
    t0 = clock()
    if distributed.is_coordinator():
        # the coordinator writes ONE minh file from the gathered streams
        w = minh.create(mp_file)
        w.header(names, TEXT, cols)
        w.geometry(L, 0, 0)
        for g, n in enumerate(sizes):
            # column order: id (Int), x (Float), mvir (Float)
            w.encoded_block(n, [enc_i.block(g)] + [
                enc_f.block(g * len(FLOAT_COLS) + k)
                for k in range(len(FLOAT_COLS))])
        w.close()
    t["write"] = clock() - t0

    # ---- sharded READ-BACK (the decode direction of the distributed
    # contract, ref go/reader.go:114-127): wait for the coordinator's
    # write, then every process decodes its OWNED row-blocks from the
    # shared file through the device decode path and bit-compares them
    # to the host reader
    distributed.barrier()
    r = minh.open(mp_file, dither="none")
    ok = True
    widths = set()
    t["read_back"] = t["host_reader"] = 0.0
    launched = decode.K2_LAUNCHES, decode.K4_LAUNCHES
    try:
        t0 = clock()
        # the rank's row-blocks are contiguous in the file: one read of
        # the span of its int blocks, one of its float blocks
        pay_i, tab_i = read_payloads(r.f, [r._block_idx(0, g) for g in mine])
        pay_f, tab_f = read_payloads(r.f, [r._block_idx(c, g) for g in mine
                                           for c in FLOAT_COLS])
        t["read_back"] += clock() - t0
        for k, g in enumerate(mine):
            n = sizes[g]
            t0 = clock()
            dec_i = be.decode_int_blocks(pay_i[k:k + 1], tab_i.mins[k:k + 1],
                                         tab_i.bits[k:k + 1], n)[0]
            fs = slice(k * len(FLOAT_COLS), (k + 1) * len(FLOAT_COLS))
            lowp, highp, pixp, perp = (a[fs] for a in tab_f.config)
            dec_f = be.decode_float_blocks(
                pay_f[fs], tab_f.mins[fs], tab_f.bits[fs], lowp, highp, pixp,
                n, periodic=perp, dither="none")
            t1 = clock()
            host_i = r.int_block(g, ["id"])["id"]
            # the raw decode, before the reader's 10**x of a log column
            host_f = [r.f.data(r._block_idx(c, g)) for c in FLOAT_COLS]
            t["read_back"] += t1 - t0
            t["host_reader"] += clock() - t1
            ok = ok and np.array_equal(dec_i, host_i) and all(
                np.array_equal(d.view(np.uint32), h.view(np.uint32))
                for d, h in zip(dec_f, host_f))
            widths.add(int(tab_i.bits[k]))
    finally:
        r.close()
    read_back = {"K2": decode.K2_LAUNCHES - launched[0],
                 "K4": decode.K4_LAUNCHES - launched[1]}

    banned = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "minnow_tpu"))
    with open("%s.rank%d.json" % (out_file, rank), "w") as f:
        json.dump({"rank": rank, "ok": bool(ok), "blocks": len(mine),
                   "device": str(dev), "seconds": t, "bytes_sent": sent,
                   "int_widths": sorted(widths), "banned_modules": banned,
                   "read_back_launches": read_back,
                   "launches": {"K1": encode.K1_LAUNCHES,
                                "K2": decode.K2_LAUNCHES,
                                "K3": encode.K3_LAUNCHES,
                                "K3 stats": encode.K3_STATS_LAUNCHES,
                                "K3 plan": encode.K3_PLAN_LAUNCHES,
                                "K4": decode.K4_LAUNCHES,
                                "K5": encode.K5_LAUNCHES}}, f)
    distributed.barrier()
    if num > 1:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    # bind-then-release a free port: a fixed port collides when two runs
    # overlap
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(cmds, env, timeout: float) -> None:
    """Run the workers to their end; a failure or the time limit stops
    them all and raises."""
    procs = [subprocess.Popen(cmd, env=env, cwd=ROOT) for cmd in cmds]
    deadline = time.monotonic() + timeout
    failed = None
    try:
        pending = list(enumerate(procs))
        while pending and failed is None:
            for rank, p in list(pending):
                rc = p.poll()
                if rc is None:
                    continue
                pending.remove((rank, p))
                if rc != 0:
                    failed = "worker %d exited with code %d" % (rank, rc)
            if pending and time.monotonic() > deadline:
                failed = "workers %s still running after %g s" % (
                    [rank for rank, _ in pending], timeout)
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed:
        raise RuntimeError("multiprocess gather check: " + failed)


def run(num_procs: int = 4, mode: str = "auto", device: str = "cuda",
        rows: int = BASE_ROWS, timeout: float = 300.0,
        work_dir: str = None) -> dict:
    """Run the check; returns its report, raises at the first failure.
    The files stay in ``work_dir`` when one is given."""
    if mode not in ("auto", "gather", "allgather"):
        raise SystemExit("unknown --mode %r" % mode)
    if device not in ("cuda", "cpu"):
        raise SystemExit("unknown --device %r" % device)
    block_sizes(rows)
    with tempfile.TemporaryDirectory() as tmp:
        out_file = os.path.join(work_dir or tmp, "gather_%s_%d"
                                % (mode, num_procs))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        port = _free_port()
        t0 = time.perf_counter()
        _run_workers([[sys.executable, "-m",
                       "minnow_torch.tools.multiprocess_gather_check",
                       "worker", str(i), str(num_procs), str(port), out_file,
                       mode, device, str(rows)] for i in range(num_procs)],
                     env, timeout)
        seconds = time.perf_counter() - t0

        ranks = []
        for p in range(num_procs):
            with open("%s.rank%d.json" % (out_file, p)) as f:
                ranks.append(json.load(f))
        counts = [r["blocks"] for r in ranks]
        if counts != owner_counts(num_procs):
            raise AssertionError("owner counts %s" % counts)
        ref_file = out_file + ".ref.minh"
        write_host_minh(ref_file, make_catalog(rows))
        with open(out_file + ".minh", "rb") as f:
            mp_bytes = f.read()
        with open(ref_file, "rb") as f:
            ref_bytes = f.read()
        if mp_bytes != ref_bytes:
            raise AssertionError("multiprocess minh differs from the host "
                                 "write (%d and %d bytes)"
                                 % (len(mp_bytes), len(ref_bytes)))
        for r in ranks:
            if not r["ok"]:
                raise AssertionError("sharded decode mismatch on process %d"
                                     % r["rank"])
            if r["banned_modules"]:
                raise AssertionError("process %d imported %s"
                                     % (r["rank"], r["banned_modules"]))
    return {"procs": num_procs, "mode": mode, "device": device,
            "rows": rows, "file_bytes": len(mp_bytes), "counts": counts,
            "seconds": seconds, "ranks": ranks}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "worker":
        rank, num, port, out_file, mode, device, rows = argv[1:8]
        worker(int(rank), int(num), int(port), out_file, mode, device,
               int(rows))
        return 0
    kw = {}
    for a in argv:
        key, _, val = a.partition("=")
        if key == "--procs":
            kw["num_procs"] = int(val)
        elif key == "--mode":
            kw["mode"] = val
        elif key == "--device":
            kw["device"] = val
        elif key == "--rows":
            kw["rows"] = int(val)
        elif key == "--timeout":
            kw["timeout"] = float(val)
        else:
            raise SystemExit(__doc__)
    report = run(**kw)
    print("multiprocess gather OK: %d processes on %s (mode=%s), unequal "
          "block counts %s, ragged lens, coordinator-written minh "
          "byte-identical to a single-process host write (%d bytes); "
          "sharded read-back bit-exact on every process"
          % (report["procs"], report["device"], report["mode"],
             report["counts"], report["file_bytes"]))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
