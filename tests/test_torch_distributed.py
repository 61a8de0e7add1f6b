"""The port's multi-process writer on ``torch.distributed`` (gloo), on the
CPU: real worker processes through
``minnow_torch.tools.multiprocess_gather_check`` (unequal per-process block
counts, ragged block lengths, ``gather_blocks`` ordering, a
coordinator-written minh file byte-compared with a single-process host
write, a sharded read-back bit-compared on every process), the wire
format of the coordinator gather against the JAX package's, and the
start-up rule of ``init_distributed``.  Tolerance zero."""

import os
import sys
import time

import numpy as np
import pytest
import torch.distributed as dist

from minnow_tpu.formats import minh as jax_minh
from minnow_tpu.parallel import distributed as jax_distributed
from minnow_tpu.parallel.pipeline import EncodedBlocks as JaxEncodedBlocks
from minnow_torch.parallel import distributed
from minnow_torch.parallel.pipeline import BlockEncoder, EncodedBlocks
from minnow_torch.tools import multiprocess_gather_check as tool

# seconds each run's workers get; a run takes 3-6 s on an idle machine
LIMIT = 240


def _reference_file(path, rows=tool.BASE_ROWS):
    """The tool's catalog written by the JAX package's host writer."""
    cols = [jax_minh.Column(type=jax_minh.Int),
            jax_minh.Column(type=jax_minh.Float, low=0.0, high=tool.L,
                            dx=tool.EPS),
            jax_minh.Column(type=jax_minh.Float, log=1,
                            low=float(np.log10(tool.MVIR_LO)),
                            high=float(np.log10(tool.MVIR_HI)),
                            dx=tool.MVIR_EPS)]
    w = jax_minh.create(str(path))
    w.header(["id", "x", "mvir"], tool.TEXT, cols)
    w.geometry(tool.L, 0, 0)
    for block in tool.make_catalog(rows):
        w.block(list(block))
    w.close()
    return path.read_bytes()


@pytest.mark.parametrize("procs,mode", [(2, "allgather"), (2, "gather"),
                                        (8, "gather"), (8, "allgather"),
                                        (3, "auto"), (8, "auto"),
                                        (1, "auto")])
def test_processes_write_one_file_and_read_it_back(tmp_path, procs, mode):
    report = tool.run(procs, mode, "cpu", timeout=LIMIT,
                      work_dir=str(tmp_path))
    assert report["counts"] == tool.owner_counts(procs)
    if procs in (2, 3, 8):
        assert len(set(report["counts"])) > 1  # unequal shares
    assert [r["ok"] for r in report["ranks"]] == [True] * procs
    # every block's ID column is wider than 32 bits
    assert all(w > 32 for r in report["ranks"] for w in r["int_widths"])
    # no kernel launches on the CPU: the plain versions ran
    assert all(set(r["launches"].values()) == {0} for r in report["ranks"])
    written = (tmp_path / ("gather_%s_%d.minh" % (mode, procs))).read_bytes()
    assert len(written) == report["file_bytes"]
    assert written == _reference_file(tmp_path / "jax.minh")


def test_a_larger_catalog_scales_the_blocks(tmp_path):
    report = tool.run(2, "gather", "cpu", rows=10 * tool.BASE_ROWS,
                      timeout=LIMIT, work_dir=str(tmp_path))
    assert report["rows"] == 5630
    assert (tmp_path / "gather_gather_2.minh").read_bytes() == \
        _reference_file(tmp_path / "jax.minh", 5630)
    with pytest.raises(SystemExit, match="multiple of 563"):
        tool.run(2, rows=1000)
    with pytest.raises(SystemExit, match="--mode"):
        tool.run(2, mode="scatter")


@pytest.mark.parametrize("cmds,limit,words", [
    ([["-c", "import sys; sys.exit(3)"],
      ["-c", "import time; time.sleep(120)"]], 60, "worker 0 exited with "
     "code 3"),
    ([["-c", "pass"], ["-c", "import time; time.sleep(120)"]], 1.0,
     r"workers \[1\] still running"),
])
def test_a_failed_or_late_worker_fails_the_run(cmds, limit, words):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=words):
        tool._run_workers([[sys.executable] + c for c in cmds],
                          dict(os.environ), limit)
    assert time.monotonic() - t0 < 30  # the sleeper was stopped, not awaited


def _blocks(cls):
    return cls([b"abc", b"", b"\x00\xff" * 7, b"\x01"],
               np.array([-(1 << 63), (1 << 62) + 5, (1 << 53) + 1, -5],
                        np.int64),
               np.array([3, 63, 0, 64], np.int64),
               np.array([10, 20, 30, 1], np.int64))


def _empty(cls):
    return cls([], np.empty(0, np.int64), np.empty(0, np.int64),
               np.empty(0, np.int64))


@pytest.mark.parametrize("make", [_blocks, _empty])
def test_pack_shard_is_the_reference_s_blob_and_round_trips(make):
    enc = make(EncodedBlocks)
    blob = distributed._pack_shard(enc)
    assert blob == jax_distributed._pack_shard(make(JaxEncodedBlocks))
    for unpack in (distributed._unpack_shard, jax_distributed._unpack_shard):
        p, m, b, ln = unpack(blob)
        assert p == enc.payloads
        np.testing.assert_array_equal(m, enc.mins)
        np.testing.assert_array_equal(b, enc.bits)
        np.testing.assert_array_equal(ln, enc.lens)


def test_pack_shard_of_encoded_batches_equals_the_reference_s():
    rng = np.random.default_rng(0)
    x = rng.integers(-(1 << 62), 1 << 62, (5, 40))
    lens = np.array([40, 0, 17, 40, 1])
    enc = BlockEncoder("cpu").encode_int_blocks(x, lens=lens)
    ref = JaxEncodedBlocks(enc.payloads, enc.mins, enc.bits, enc.lens)
    assert distributed._pack_shard(enc) == jax_distributed._pack_shard(ref)


INTENT = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "SLURM_NTASKS",
          "SLURM_STEP_NUM_TASKS", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE")


@pytest.fixture
def clean_env(monkeypatch):
    for name in INTENT:
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()
    yield monkeypatch
    if dist.is_initialized():
        dist.destroy_process_group()


def test_init_distributed_is_a_no_op_without_intent(clean_env):
    clean_env.setenv("SLURM_NTASKS", "1")  # a single-task job inside salloc
    clean_env.setenv("SLURM_JOB_ID", "12345")
    distributed.init_distributed()
    assert not dist.is_initialized()
    assert distributed.is_coordinator()
    distributed.barrier()
    enc = _blocks(EncodedBlocks)
    for mode in (None, "gather", "allgather"):
        assert distributed.gather_blocks(enc, mode=mode) is enc


@pytest.mark.parametrize("env", [{"WORLD_SIZE": "2"}, {"RANK": "0"},
                                 {"MASTER_ADDR": "localhost"},
                                 {"SLURM_NTASKS": "4"}, {"PMI_SIZE": "many"},
                                 {"OMPI_COMM_WORLD_SIZE": "2"}])
def test_init_distributed_raises_where_several_processes_were_meant(
        clean_env, env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    with pytest.raises(RuntimeError, match="refusing to continue as a single"):
        distributed.init_distributed()
    assert not dist.is_initialized()


def test_init_distributed_with_arguments_starts_once(clean_env):
    with pytest.raises(RuntimeError, match="refusing to continue"):
        distributed.init_distributed(init_method="nonsense://nowhere",
                                     world_size=2, rank=0)
    url = "tcp://localhost:%d" % tool._free_port()
    distributed.init_distributed(init_method=url, world_size=1, rank=0)
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    # a second call is a no-op, whatever it is given
    distributed.init_distributed(init_method="nonsense://nowhere",
                                 world_size=2, rank=1)
    assert dist.get_world_size() == 1 and distributed.is_coordinator()
    enc = _blocks(EncodedBlocks)
    assert distributed.gather_blocks(enc) is enc
    # the transport of host bytes is gloo: no other backend can be asked
    dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="backend"):
        distributed.init_distributed(backend="nccl", init_method=url,
                                     world_size=1, rank=0)
