"""The port's text_to_minh, end to end on the CPU: the file it writes
equals the host codec's and the JAX package's --device file byte for
byte, --jobs=N writes the files of the sequential loop and of the
reference's --jobs, --device refuses to run without CUDA, and the port (converter,
readers, minh_to_bnd, the minp converter and reader) runs with jax and
minnow_tpu unimportable."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from minnow_tpu.cli import text_to_minh as jax_text_to_minh
from minnow_tpu.formats import minh
from minnow_torch.cli import text_to_minh
from minnow_torch.formats import minh_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_catalog(tmp_path, n=400, seed=0):
    """A Rockstar-style catalog (the test_cli.py layout plus two ``int``
    columns) with its config, name and type indices."""
    rng = np.random.default_rng(seed)
    ids = np.arange(n) + (1 << 40)
    pid = np.where(rng.random(n) < 0.8, -1, ids[rng.integers(0, n, n)])
    xs, ys, zs = (rng.uniform(0, 99.9, n) for _ in range(3))
    mvir = 10.0 ** rng.uniform(9, 14, n)
    lines = ["#ID PID X Y Z Mvir Weird"]
    for i in range(n):
        lines.append("%d %d %.5f %.5f %.5f %.6e 1.0"
                     % (ids[i], pid[i], xs[i], ys[i], zs[i], mvir[i]))
    hlist = tmp_path / "hlist_1.00000.list"
    hlist.write_text("\n".join(lines) + "\n")
    (tmp_path / "names.txt").write_text(
        "id ID haloid\npid PID\nx X\ny Y\nz Z\nmvir Mvir M200\n"
        "weird Weird\n")
    (tmp_path / "types.txt").write_text(
        "id int64\npid int\nx q_float position\ny q_float position\n"
        "z q_float position\nmvir q_float log 1e5 1e16 0.001\n"
        "weird float32\n")
    config = tmp_path / "run.config"
    config.write_text(
        "[minh]\nL = 100\nEpsilon = 0.01\nMp = 1e8\nMinParticles = 10\n"
        "MassName = mvir\nNameIndex = %s\nTypeIndex = %s\n"
        % (tmp_path / "names.txt", tmp_path / "types.txt"))
    return config, hlist


def _convert(convert_file, config, hlist, out, device, block_size):
    cfg = jax_text_to_minh.parse_config(str(config))
    idx = jax_text_to_minh.open_index(cfg["NameIndex"])
    types = jax_text_to_minh.parse_types(cfg["TypeIndex"], idx)
    wanted = jax_text_to_minh.parse_vars("all", idx)
    convert_file(cfg, idx, types, wanted, str(hlist), str(out), device,
                 block_size=block_size)


# 4000-byte text blocks make several row-blocks (and minnow blocks) per
# column; None keeps the reference's one row-block
@pytest.mark.parametrize("block_size", [None, 4000])
def test_port_file_equals_host_and_jax_device_files(tmp_path, block_size):
    config, hlist = write_catalog(tmp_path)
    port, host = tmp_path / "port.minh", tmp_path / "host.minh"
    port_host = tmp_path / "port_host.minh"
    _convert(text_to_minh.convert_file, config, hlist, port, "cpu",
             block_size)
    _convert(text_to_minh.convert_file, config, hlist, port_host, None,
             block_size)
    # the reference's host converter: its own prefetch loop and mass cut
    _convert(jax_text_to_minh.convert_file, config, hlist, host, False,
             block_size)
    out = tmp_path / "out"
    out.mkdir()
    flags = ["--device"] + ([] if block_size is None
                            else ["--block-size=%d" % block_size])
    jax_text_to_minh.main([str(config), "all", str(hlist), str(out)]
                          + flags)
    jax_file = out / "hlist_1.00000.minh"
    assert port.read_bytes() == host.read_bytes()
    assert port_host.read_bytes() == host.read_bytes()
    assert port.read_bytes() == jax_file.read_bytes()

    r = minh.open(str(port), dither="uniform", seed=3)
    try:
        assert (r.blocks > 1) == (block_size is not None)
        got = minh_device.read_floats(r, ["x", "mvir"], "cpu")
        want = r.floats(["x", "mvir"])
        ints = r.ints(["pid"])["pid"]
    finally:
        r.close()
    for name in ("x", "mvir"):
        np.testing.assert_array_equal(got[name].view(np.int32),
                                      want[name].view(np.int32))
    assert (ints == -1).any() and ints.max() > (1 << 40)


def test_device_flag_needs_cuda(tmp_path, monkeypatch):
    config, hlist = write_catalog(tmp_path, n=20)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        text_to_minh.main([str(config), "all", str(hlist), str(tmp_path),
                           "--device"])
    assert not list(tmp_path.glob("*.minh"))


def _catalogs(tmp_path, sizes=(300, 40, 120)):
    """Several catalogs of different sizes under one config, as
    ``snap_<i>.list``; returns the config and the glob."""
    config = None
    for i, n in enumerate(sizes):
        d = tmp_path / ("cat%d" % i)
        d.mkdir()
        config, hlist = write_catalog(d, n=n, seed=10 + i)
        hlist.rename(tmp_path / ("snap_%d.list" % i))
    return config, str(tmp_path / "snap_*.list")


def _parsed(config):
    cfg = text_to_minh.parse_config(str(config))
    idx = text_to_minh.open_index(cfg["NameIndex"])
    return (cfg, idx, text_to_minh.parse_types(cfg["TypeIndex"], idx),
            text_to_minh.parse_vars("all", idx))


def _files(d):
    return {f.name: f.read_bytes() for f in sorted(d.glob("*.minh"))}


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("jobs", [2, 8])
def test_jobs_write_the_files_of_the_sequential_loop(tmp_path, device, jobs,
                                                     monkeypatch):
    """``convert_files`` with several jobs, on the host codec and on the
    device encoder (one ``BlockEncoder`` shared by the jobs), against one
    job and against the reference's ``convert_files``."""
    import glob

    from minnow_torch.parallel import pipeline

    config, pattern = _catalogs(tmp_path)
    files = sorted(glob.glob(pattern))
    made = []
    real = pipeline.BlockEncoder

    def counting(dev):
        made.append(dev)
        return real(dev)

    monkeypatch.setattr(text_to_minh, "BlockEncoder", counting)
    outs = {}
    for name, n in (("one", 1), ("many", jobs)):
        outs[name] = tmp_path / name
        outs[name].mkdir()
        logged = []
        text_to_minh.convert_files(*_parsed(config), files, str(outs[name]),
                                   device=device, jobs=n, block_size=4000,
                                   log=logged.append)
        assert sum(line.startswith("Converting") for line in logged) == 3
    assert made == ([] if device is None else ["cpu", "cpu"])
    ref = tmp_path / "ref"
    ref.mkdir()
    jax_text_to_minh.convert_files(*_parsed(config), files, str(ref),
                                   jobs=jobs, block_size=4000,
                                   log=lambda line: None)
    assert sorted(_files(outs["many"])) == ["snap_0.minh", "snap_1.minh",
                                            "snap_2.minh"]
    assert _files(outs["many"]) == _files(outs["one"]) == _files(ref)


def test_jobs_flag_matches_the_reference_s(tmp_path, capsys):
    config, pattern = _catalogs(tmp_path)
    port, ref = tmp_path / "port", tmp_path / "ref"
    port.mkdir()
    ref.mkdir()
    text_to_minh.main([str(config), "all", pattern, str(port), "--jobs=2",
                       "--block-size=4000"])
    lines = capsys.readouterr().out.splitlines()
    # biggest file first
    assert lines[0] == "Converting %s" % str(tmp_path / "snap_0.list")
    assert len(lines) == 6
    jax_text_to_minh.main([str(config), "all", pattern, str(ref),
                           "--jobs=2", "--block-size=4000"])
    assert len(_files(port)) == 3 and _files(port) == _files(ref)


def test_jobs_refuse_two_inputs_of_one_output_name(tmp_path):
    config, _ = _catalogs(tmp_path, sizes=(30,))
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    files = []
    for d in "ab":
        files.append(str(tmp_path / d / "snap.list"))
        (tmp_path / d / "snap.list").write_bytes(
            (tmp_path / "snap_0.list").read_bytes())
    with pytest.raises(SystemExit, match="both map to output"):
        text_to_minh.convert_files(*_parsed(config), files, str(tmp_path),
                                   jobs=2)
    assert not list(tmp_path.glob("*.minh"))


BLOCK_JAX = textwrap.dedent("""
    import importlib.abc, sys

    class NoJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "minnow_tpu"):
                raise ImportError("refused here: " + name)

    sys.meta_path.insert(0, NoJax())
    sys.path.insert(0, sys.argv[1])
    import pathlib
    import numpy as np
    import minnow_torch
    from minnow_torch.cli import inspect_minh, minh_to_bnd, text_to_minh
    from minnow_torch.formats import minh, minh_device
    from minnow_torch.ops import _build, bitpack, codec, decode, encode
    from minnow_torch.parallel import pipeline
    from minnow_torch.utils import device

    tmp = pathlib.Path(sys.argv[2])
    text_to_minh.main([str(tmp / "run.config"), "all",
                       str(tmp / "hlist_1.00000.list"), str(tmp)])
    fname = str(tmp / "hlist_1.00000.minh")
    cfg = text_to_minh.parse_config(str(tmp / "run.config"))
    idx = text_to_minh.open_index(cfg["NameIndex"])
    text_to_minh.convert_file(
        cfg, idx, text_to_minh.parse_types(cfg["TypeIndex"], idx),
        text_to_minh.parse_vars("all", idx),
        str(tmp / "hlist_1.00000.list"), str(tmp / "port.minh"), "cpu")
    assert open(fname, "rb").read() == open(tmp / "port.minh", "rb").read()
    r = minh.open(fname)
    got = minh_device.read_floats(r, ["x", "mvir"], "cpu")
    want = r.floats(["x", "mvir"])
    for k in got:
        assert (got[k].view(np.int32) == want[k].view(np.int32)).all()
    assert (minh_device.read_ints(r, ["pid"], "cpu")["pid"]
            == r.ints(["pid"])["pid"]).all()
    r.close()
    minh_to_bnd.main(["2", "5.0", fname, str(tmp)])
    minh_to_bnd.convert_file(fname, str(tmp / "port.bnd.minh"), 2, 5.0,
                             "cpu")
    assert open(tmp / "hlist_1.00000.bnd.minh", "rb").read() == \
        open(tmp / "port.bnd.minh", "rb").read()
    inspect_minh.inspect(str(tmp / "port.bnd.minh"), ["pid"], "cpu")

    from minnow_torch.cli import convert_snapshot
    from minnow_torch.formats import minp, minp_device
    from minnow_torch.ingest import lgadget2, snapshot
    rng = np.random.default_rng(1)
    n = 64
    hd = minp.Header(l=50.0, omega_m=0.3, n_side=4, n_total=n)
    snapshot.calc_uniform_mass(hd)
    snap = snapshot.MockSnapshot(
        hd, [rng.uniform(0, 49, (n, 3)).astype(np.float32)],
        [rng.normal(0, 50, (n, 3)).astype(np.float32)], [np.arange(1, n + 1)])
    for d in ("gadget", "minp"):
        (tmp / d).mkdir()
    lgadget2.write_lgadget2(
        str(tmp / "gadget"), "snap_%03d.dat", snap,
        lgadget2.LGadget2Header(time=1.0, box_size=50.0,
                                n_part_total=(0, n, 0, 0, 0, 0)))
    convert_snapshot.to_minp(str(tmp / "gadget"), str(tmp / "minp"), 1, 2,
                             0.001, 0.01, "cpu")
    for kind in "xv":
        with minp.open(str(tmp / "minp" / ("%s_0.minp" % kind))) as r:
            got = minp_device.read_vectors(r, "cpu").numpy()
            assert (got.view(np.uint32) == r.vectors().view(np.uint32)).all()
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "minnow_tpu")]
    assert not loaded, loaded
    print("NO_JAX_OK")
""")


def test_port_runs_with_jax_unimportable(tmp_path):
    write_catalog(tmp_path, n=100, seed=2)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", BLOCK_JAX, REPO,
                          str(tmp_path)], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout
