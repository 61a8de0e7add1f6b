"""The port's four CLIs in host mode (no ``--device``) against the JAX
package's, file for file and line for line, on the same inputs; and the
parts each CLI module now holds itself (config, type and variable
parsing, output names, the device writer of ``text_to_minh``)."""

import numpy as np
import pytest

from minnow_tpu.cli import convert_snapshot as ref_convert_snapshot
from minnow_tpu.cli import inspect_minh as ref_inspect_minh
from minnow_tpu.cli import minh_to_bnd as ref_minh_to_bnd
from minnow_tpu.cli import text_to_minh as ref_text_to_minh
from minnow_tpu.ingest import lgadget2 as ref_lgadget2
from minnow_tpu.ingest import snapshot as ref_snapshot
from minnow_tpu.formats import minp as ref_minp
from minnow_torch.cli import (convert_snapshot, inspect_minh, minh_to_bnd,
                              text_to_minh)

from test_torch_text_to_minh import write_catalog


def _dirs(tmp_path):
    out = {}
    for name in ("port", "ref"):
        out[name] = tmp_path / name
        out[name].mkdir()
    return out


def _same_files(dirs, count):
    names = sorted(f.name for f in dirs["ref"].iterdir())
    assert names == sorted(f.name for f in dirs["port"].iterdir())
    assert len(names) == count
    for f in names:
        assert (dirs["port"] / f).read_bytes() \
            == (dirs["ref"] / f).read_bytes(), f
    return names


@pytest.mark.parametrize("flags", [[], ["--block-size=4000"]])
def test_text_to_minh_host_mode(tmp_path, flags, capsys):
    config, hlist = write_catalog(tmp_path, n=600, seed=3)
    dirs = _dirs(tmp_path)
    args = [str(config), "all", str(hlist)]
    text_to_minh.main(args + [str(dirs["port"])] + flags)
    ref_text_to_minh.main(args + [str(dirs["ref"])] + flags)
    assert _same_files(dirs, 1) == ["hlist_1.00000.minh"]
    capsys.readouterr()


def test_text_to_minh_parsers(tmp_path):
    config, hlist = write_catalog(tmp_path, n=10)
    cfg, ref_cfg = text_to_minh.parse_config(str(config)), \
        ref_text_to_minh.parse_config(str(config))
    keys = ("L", "Epsilon", "Mp", "MinParticles", "MassName", "NameIndex",
            "TypeIndex")
    assert [cfg[k] for k in keys] == [ref_cfg[k] for k in keys]
    idx = text_to_minh.open_index(cfg["NameIndex"])
    ref_idx = ref_text_to_minh.open_index(cfg["NameIndex"])
    types = text_to_minh.parse_types(cfg["TypeIndex"], idx)
    assert types == ref_text_to_minh.parse_types(cfg["TypeIndex"], ref_idx)
    assert text_to_minh.parse_vars("all", idx) \
        == ref_text_to_minh.parse_vars("all", ref_idx)
    some = tmp_path / "vars.txt"
    some.write_text("ID mvir\nX\n")
    assert text_to_minh.parse_vars(str(some), idx) \
        == ref_text_to_minh.parse_vars(str(some), ref_idx) \
        == {"id", "mvir", "x"}
    for name, t in types.items():
        col, dtype = text_to_minh.column_from_type(cfg, t)
        ref_col, ref_dtype = ref_text_to_minh.column_from_type(ref_cfg, t)
        assert vars(col) == vars(ref_col) and dtype == ref_dtype, name
    for f in ("hlist_1.00000.list", "a/b/tree", "x.y.z"):
        assert text_to_minh.out_name("out", f) \
            == ref_text_to_minh.out_name("out", f)
        assert minh_to_bnd.out_name("out", f) \
            == ref_minh_to_bnd.out_name("out", f)
    assert text_to_minh.THREADS == ref_text_to_minh.THREADS
    missing = tmp_path / "missing.config"
    missing.write_text("[minh]\nL = 100\n")
    with pytest.raises(SystemExit):
        text_to_minh.parse_config(str(missing))


@pytest.fixture
def minh_file(tmp_path, capsys):
    config, hlist = write_catalog(tmp_path, n=500, seed=4)
    ref_text_to_minh.main([str(config), "all", str(hlist), str(tmp_path)])
    capsys.readouterr()
    return tmp_path / "hlist_1.00000.minh"


def test_minh_to_bnd_host_mode(tmp_path, minh_file, capsys):
    dirs = _dirs(tmp_path)
    minh_to_bnd.main(["2", "5.0", str(minh_file), str(dirs["port"])])
    ref_minh_to_bnd.main(["2", "5.0", str(minh_file), str(dirs["ref"])])
    assert _same_files(dirs, 1) == ["hlist_1.00000.bnd.minh"]
    capsys.readouterr()


@pytest.mark.parametrize("columns", [[], ["x", "pid"]])
def test_inspect_minh_host_mode(minh_file, columns, capsys):
    inspect_minh.main([str(minh_file)] + columns)
    got = capsys.readouterr().out
    ref_inspect_minh.main([str(minh_file)] + columns)
    assert got == capsys.readouterr().out
    assert "rows      : " in got and "min=" in got


def test_inspect_minh_plot(minh_file, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    inspect_minh.main([str(minh_file), "mvir", "--plot",
                       str(tmp_path / "port.png")])
    got = capsys.readouterr().out.replace("port.png", "ref.png")
    ref_inspect_minh.main([str(minh_file), "mvir", "--plot",
                           str(tmp_path / "ref.png")])
    assert got == capsys.readouterr().out
    assert (tmp_path / "port.png").stat().st_size > 1000


def test_convert_snapshot_host_mode_both_ways(tmp_path):
    rng = np.random.default_rng(6)
    n_side, n = 8, 512
    hd = ref_minp.Header(z=0.0, scale=1.0, omega_m=0.3, omega_l=0.7,
                         h100=0.7, l=50.0, n_side=n_side, n_total=n)
    ref_snapshot.calc_uniform_mass(hd)
    order = np.array_split(rng.permutation(n), 2)
    pos = rng.uniform(0, 50, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 100, (n, 3)).astype(np.float32)
    snap = ref_snapshot.MockSnapshot(hd, [pos[o] for o in order],
                                     [vel[o] for o in order],
                                     [o + 1 for o in order])
    gadget = tmp_path / "gadget"
    gadget.mkdir()
    ref_lgadget2.write_lgadget2(
        str(gadget), "snap_%03d.dat", snap, ref_lgadget2.LGadget2Header(
            time=1.0, box_size=50.0, omega0=0.3, omega_lambda=0.7,
            hubble_param=0.7, n_part_total=(0, n, 0, 0, 0, 0), num_files=2))
    dirs = _dirs(tmp_path)
    args = ["2", "2", "0.001", "0.25"]
    convert_snapshot.main(["to_minp", str(gadget), str(dirs["port"])] + args)
    ref_convert_snapshot.main(["to_minp", str(gadget), str(dirs["ref"])]
                              + args)
    assert len(_same_files(dirs, 16)) == 16
    back = {name: tmp_path / ("back_" + name) for name in dirs}
    for d in back.values():
        d.mkdir()
    convert_snapshot.main(["to_lgadget2", str(dirs["ref"]), "%s_%d.minp",
                           str(back["port"])])
    ref_convert_snapshot.main(["to_lgadget2", str(dirs["port"]), "%s_%d.minp",
                               str(back["ref"])])
    assert len(_same_files(back, 8)) == 8
    with pytest.raises(SystemExit):
        convert_snapshot.main(["to_minp", str(gadget)])
