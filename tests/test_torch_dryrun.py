"""The port's file-level dry runs (``minnow_torch.tools.dryrun``) on 1,
2, 3 and 8 CPU shares, every step a case, against the reference's own
dry-run steps (``__graft_entry__.py``) on a mesh of virtual CPU devices:
the files the two write are byte-compared, decoded columns bitwise, and
encoded batches against the JAX encoder byte for byte."""

import contextlib
import os
import tempfile

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import __graft_entry__ as graft
from minnow_tpu.core import spec
from minnow_tpu.formats import minh as jax_minh
from minnow_tpu.parallel import BlockEncoder as JaxBlockEncoder
from minnow_torch.tools import dryrun

SHARES = (1, 2, 3, 8)


def _mesh(k=2):
    devs = jax.devices()[:k]
    if len(devs) < k:
        pytest.skip("needs %d virtual devices" % k)
    return Mesh(np.asarray(devs).reshape(k, 1), ("blocks", "elems"))


def _reference_files(step, monkeypatch, tmp_path, mesh):
    """Run the reference's dry-run ``step`` with its temporary directory
    kept; returns ``{file name: bytes}``."""
    @contextlib.contextmanager
    def kept():
        yield str(tmp_path)

    monkeypatch.setattr(tempfile, "TemporaryDirectory", kept)
    step(mesh)
    return {f: (tmp_path / f).read_bytes() for f in os.listdir(tmp_path)}


def _assert_same_blocks(got, want):
    assert got.payloads == want.payloads
    np.testing.assert_array_equal(got.mins, want.mins)
    np.testing.assert_array_equal(got.bits, want.bits)
    np.testing.assert_array_equal(got.lens, want.lens)


@pytest.mark.parametrize("k", SHARES)
def test_entry(k):
    got = dryrun.entry(["cpu"] * k)
    x, low, high, pixels, lens, periodic = graft._example_batch(8, 32768)
    for a, b in zip(dryrun._example_batch(8, 32768),
                    (x, low, high, pixels, lens, periodic)):
        np.testing.assert_array_equal(a, b)
    want = JaxBlockEncoder(pallas=False).encode_float_blocks(
        x, low, high, pixels, lens=lens, periodic=periodic)
    _assert_same_blocks(got, want)
    assert set(got.bits) == {18}


@pytest.mark.parametrize("k", SHARES)
def test_pallas_shard(k):
    got = dryrun.dryrun_pallas_shard(["cpu"] * k)
    rng = np.random.default_rng(5)
    pixels = spec.float_group_pixels(0.0, 250.0, 0.001)
    x = rng.uniform(0, 249.9, (8, 512)).astype(np.float32)
    _assert_same_blocks(got, JaxBlockEncoder(pallas=False)
                        .encode_float_blocks(x, 0.0, 250.0, pixels))
    if k == 2:  # and the reference's kernel under its mesh, interpreted
        graft._dryrun_pallas_shard(_mesh(2))
        _assert_same_blocks(got, JaxBlockEncoder(mesh=_mesh(2), pallas=True)
                            .encode_float_blocks(x, 0.0, 250.0, pixels))


@pytest.mark.parametrize("k", SHARES)
def test_production_writer(k, monkeypatch, tmp_path):
    got = dryrun.dryrun_production_writer(["cpu"] * k)
    ref = _reference_files(graft._dryrun_production_writer, monkeypatch,
                           tmp_path, _mesh(min(k, 2)))
    assert got == ref["dev.minh"] == ref["host.minh"]


@pytest.mark.parametrize("k", SHARES)
def test_sharded_decode(k, monkeypatch, tmp_path):
    got = dryrun.dryrun_sharded_decode(["cpu"] * k)
    ref = _reference_files(graft._dryrun_sharded_decode, monkeypatch,
                           tmp_path, _mesh(min(k, 2)))
    assert list(ref) == ["dec.minh"]
    assert sorted(got) == ["id", "x midpoint", "x none", "x uniform"]
    for mode in ("none", "midpoint", "uniform"):
        r = jax_minh.open(str(tmp_path / "dec.minh"), dither=mode, seed=11)
        try:
            np.testing.assert_array_equal(got["id"].reshape(-1),
                                          r.ints(["id"])["id"])
            np.testing.assert_array_equal(
                got["x " + mode].reshape(-1).view(np.int32),
                r.floats(["x"])["x"].view(np.int32))
        finally:
            r.close()
    assert not np.array_equal(got["x none"], got["x uniform"])


@pytest.mark.parametrize("k", SHARES)
def test_minp_mesh(k, monkeypatch, tmp_path):
    got = dryrun.dryrun_minp_mesh(["cpu"] * k)
    ref = _reference_files(graft._dryrun_minp_mesh, monkeypatch, tmp_path,
                           _mesh(min(k, 2)))
    assert got == ref["mesh.minp"] == ref["host.minp"]


@pytest.mark.parametrize("k", SHARES)
def test_boundary_mesh(k, monkeypatch, tmp_path):
    got = dryrun.dryrun_boundary_mesh(["cpu"] * k)
    ref = _reference_files(graft._dryrun_boundary_mesh, monkeypatch,
                           tmp_path, _mesh(min(k, 2)))
    assert got == ref["mesh.minh"] == ref["host.minh"]


@pytest.mark.parametrize("k", SHARES)
def test_ragged_buckets(k):
    got_f, got_i = dryrun.dryrun_ragged_buckets(["cpu"] * k)
    # the reference's inputs, from its seed (its own step asserts a bucket
    # smaller than its mesh, so it runs on 8 devices only)
    rng = np.random.default_rng(31)
    nb, nmax = 48, 1536
    lens = rng.integers(200, nmax + 1, nb).astype(np.int64)
    lens[3] = nmax
    pixels = spec.float_group_pixels(0.0, 250.0, 0.001)
    x = np.zeros((nb, nmax), np.float32)
    for i in range(nb):
        span = 0.01 if i % 16 == 0 else (1.0 if i % 5 == 0 else 249.9)
        x[i, :lens[i]] = rng.uniform(0, span, lens[i]).astype(np.float32)
    iv = np.zeros((nb, nmax), np.int64)
    for i in range(nb):
        iv[i, :lens[i]] = rng.integers(0, 1 << (34 + (i % 3) * 4), lens[i])
    enc = JaxBlockEncoder(pallas=False)
    _assert_same_blocks(got_f, enc.encode_float_blocks(x, 0.0, 250.0, pixels,
                                                       lens=lens))
    _assert_same_blocks(got_i, enc.encode_int_blocks(iv, lens=lens))
    widths, counts = np.unique(got_f.bits, return_counts=True)
    assert len(widths) >= 3 and counts.min() < 8 and got_i.bits.max() > 32
    if k == 8:
        graft._dryrun_ragged_buckets(_mesh(8))


@pytest.mark.parametrize("k", SHARES)
def test_dryrun_runs_every_step(k):
    out = dryrun.dryrun(["cpu"] * k)
    assert list(out) == list(dryrun.STEPS)
    assert all(isinstance(out[s], bytes) and out[s] for s in
               ("production_writer", "minp_mesh", "boundary_mesh"))


def test_command_line(capsys):
    assert dryrun.main(["--devices=cpu,cpu,cpu"]) == 0
    assert "dryrun OK on 3 device(s)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        dryrun.main(["--shares=3"])


def test_default_device_needs_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun()
