"""The port's minh_to_bnd and inspect_minh, end to end on the CPU: the
boundary file equals the reference's host file byte for byte in every
dither mode (and its JAX --device file in ``none``), every column of it
reads back through the port's device readers bitwise, the summary equals
the reference's, and --device refuses to run without CUDA."""

import numpy as np
import pytest
import torch

from minnow_tpu.cli import inspect_minh as ref_inspect_minh
from minnow_tpu.cli import minh_to_bnd as ref_minh_to_bnd
from minnow_tpu.cli import text_to_minh as ref_text_to_minh
from minnow_tpu.formats import minh
from minnow_torch.cli import inspect_minh, minh_to_bnd
from minnow_torch.formats import minh_device

CELLS, BND = 4, 5.0  # L = 100: 64 cells of 25 on a side


def write_catalog(d, n=60, seed=1):
    """A small Rockstar-style catalog whose boundary layout at CELLS x
    BND has empty and one-row cells: ``int`` IDs above 2^53 and parent
    IDs (-1 or an ID), a raw int64 and a raw float32 column, positions, a
    log mass and a linear velocity.  Returns the basic minh file the
    reference's host converter writes from it."""
    rng = np.random.default_rng(seed)
    ids = np.arange(n, dtype=np.int64) * 7 + (1 << 53) + 1
    pid = np.where(rng.random(n) < 0.7, -1, ids[rng.integers(0, n, n)])
    upid = rng.integers(-(1 << 62), 1 << 62, n)
    pos = rng.uniform(0, 99.9, (3, n))
    mvir = 10.0 ** rng.uniform(9, 14, n)
    vx = rng.uniform(-900, 900, n)
    lines = ["#ID PID UPID X Y Z Mvir VX Weird"]
    for i in range(n):
        lines.append("%d %d %d %.5f %.5f %.5f %.6e %.2f %.3f"
                     % (ids[i], pid[i], upid[i], *pos[:, i], mvir[i], vx[i],
                        rng.uniform(-1, 1)))
    hlist = d / "hlist_1.00000.list"
    hlist.write_text("\n".join(lines) + "\n")
    (d / "names.txt").write_text(
        "id ID\npid PID\nupid UPID\nx X\ny Y\nz Z\nmvir Mvir\nvx VX\n"
        "weird Weird\n")
    (d / "types.txt").write_text(
        "id int\npid int\nupid int64\nx q_float position\n"
        "y q_float position\nz q_float position\n"
        "mvir q_float log 1e5 1e16 0.001\nvx q_float linear -1000 1000 0.1\n"
        "weird float32\n")
    config = d / "run.config"
    config.write_text(
        "[minh]\nL = 100\nEpsilon = 0.01\nMp = 1e8\nMinParticles = 10\n"
        "MassName = mvir\nNameIndex = %s\nTypeIndex = %s\n"
        % (d / "names.txt", d / "types.txt"))
    cfg = ref_text_to_minh.parse_config(str(config))
    idx = ref_text_to_minh.open_index(cfg["NameIndex"])
    src = d / "src.minh"
    ref_text_to_minh.convert_file(
        cfg, idx, ref_text_to_minh.parse_types(cfg["TypeIndex"], idx),
        ref_text_to_minh.parse_vars("all", idx), str(hlist), str(src),
        device=False)
    return src


@pytest.fixture
def src(tmp_path):
    return write_catalog(tmp_path)


@pytest.mark.parametrize("mode", ["none", "midpoint", "uniform"])
def test_boundary_file_equals_reference_host_file(src, tmp_path, mode):
    ref = tmp_path / "ref.bnd.minh"
    ref_minh_to_bnd.convert_file(str(src), str(ref), CELLS, BND,
                                 device=False, dither=mode)
    for device in ("cpu", None):
        port = tmp_path / ("port_%s.bnd.minh" % device)
        minh_to_bnd.convert_file(str(src), str(port), CELLS, BND, device,
                                 dither=mode)
        assert port.read_bytes() == ref.read_bytes(), device

    r = minh.open(str(ref))
    try:
        # ragged cells: empty ones and one-row ones reach K1 and K3
        assert r.blocks == CELLS ** 3
        assert 0 in r.block_lengths and 1 in r.block_lengths
        assert r.names == ["boundary", "id", "pid", "upid", "x", "y", "z",
                           "mvir", "vx", "weird"]
    finally:
        r.close()


def test_boundary_file_equals_jax_device_file(src, tmp_path):
    """The JAX --device conversion (its reader and encoder on the CPU
    backend) in the ``none`` mode, as tests/test_cli.py compares it."""
    jax_file, port = tmp_path / "jax.bnd.minh", tmp_path / "port.bnd.minh"
    ref_minh_to_bnd.convert_file(str(src), str(jax_file), CELLS, BND,
                                 device=True, dither="none")
    minh_to_bnd.convert_file(str(src), str(port), CELLS, BND, "cpu",
                             dither="none")
    assert port.read_bytes() == jax_file.read_bytes()


def test_boundary_file_reads_back_on_the_device_readers(src, tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    minh_to_bnd.main([str(CELLS), str(BND), str(src), str(out)])
    r = minh.open(str(out / "src.bnd.minh"), dither="uniform", seed=6)
    try:
        ints = [n for n, c in zip(r.names, r.columns) if c.type == minh.Int]
        floats = [n for n, c in zip(r.names, r.columns)
                  if c.type == minh.Float]
        assert ints == ["boundary", "id", "pid"] and len(floats) == 5
        got_i = minh_device.read_ints(r, ints, "cpu")
        want_i = r.ints(ints)
        got_f = minh_device.read_floats(r, floats, "cpu")
        want_f = r.floats(floats)
        for name in r.names:
            np.testing.assert_array_equal(
                minh_device.read_column(r, name, "cpu"),
                minh_device.read_column(r, name), name)
    finally:
        r.close()
    for name in ints:
        np.testing.assert_array_equal(got_i[name], want_i[name], name)
    for name in floats:
        np.testing.assert_array_equal(got_f[name].view(np.int32),
                                      want_f[name].view(np.int32), name)
    assert got_i["id"].min() > 1 << 53 and (got_i["pid"] == -1).any()


def test_inspect_output_equals_reference(src, tmp_path, capsys):
    bnd = tmp_path / "b.bnd.minh"
    ref_minh_to_bnd.convert_file(str(src), str(bnd), CELLS, BND,
                                 device=False)
    capsys.readouterr()
    for fname, names in ((src, []), (bnd, []), (bnd, ["pid", "x"])):
        ref_inspect_minh.main([str(fname), *names])
        want = capsys.readouterr().out
        inspect_minh.main([str(fname), *names])
        assert capsys.readouterr().out == want
        inspect_minh.inspect(str(fname), names, "cpu")
        assert capsys.readouterr().out == want
        assert "min=" in want


def test_device_flag_needs_cuda(src, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    out.mkdir()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        minh_to_bnd.main([str(CELLS), str(BND), str(src), str(out),
                          "--device"])
    assert not list(out.iterdir())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inspect_minh.main([str(src), "--device"])


def test_read_ints_refuses_other_columns(src):
    r = minh.open(str(src))
    try:
        for name in ("upid", "x", "weird"):
            with pytest.raises(TypeError):
                minh_device.read_ints(r, [name], "cpu")
    finally:
        r.close()
