"""The port's host ingest (``minnow_torch.ingest``, ``utils.name_index``,
``utils.config``) against the JAX package's on the same files: the text
parser, the Rockstar header dialects, the LGadget-2 reader and writer and
the snapshot ``Grid``.  Tolerance zero."""

import numpy as np
import pytest

from minnow_tpu.formats import minp as ref_minp
from minnow_tpu.ingest import lgadget2 as ref_lgadget2
from minnow_tpu.ingest import rockstar as ref_rockstar
from minnow_tpu.ingest import snapshot as ref_snapshot
from minnow_tpu.ingest import text as ref_text
from minnow_tpu.utils import config as ref_config
from minnow_tpu.utils import name_index as ref_name_index
from minnow_torch.formats import minp
from minnow_torch.ingest import lgadget2, rockstar, snapshot, text
from minnow_torch.utils import config, name_index


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def write_hlist(path, n, header):
    rng = np.random.default_rng(n)
    ids = np.arange(n) + (1 << 53) + 1
    rows = ["%d %d %.6e %.5f %.5f %.5f %.3f" % (
        ids[i], rng.integers(-1, 5), 10.0 ** rng.uniform(9, 15),
        *rng.uniform(0, 250, 3), rng.normal(0, 300)) for i in range(n)]
    path.write_text(header + "\n#a comment\n" + "\n".join(rows) + "\n")
    return str(path)


HEADERS = {"rockstar": "#ID PID Mvir X Y Z VX",
           "consistent-trees": "#ID(0) PID(1) Mvir(2) X(3) Y(4) Z(5) VX(6)"}


@pytest.mark.parametrize("block_size", [None, 3000])
@pytest.mark.parametrize("dialect", list(HEADERS))
def test_text_parser_and_rockstar_headers(tmp_path, dialect, block_size):
    fname = write_hlist(tmp_path / "hlist.list", 500, HEADERS[dialect])
    readers = []
    for mod, rs in ((text, rockstar), (ref_text, ref_rockstar)):
        cfg = None if block_size is None else mod.ReaderConfig(
            max_block_size=block_size, max_item_size=block_size // 2)
        fr = rs.open_rockstar(fname, cfg)
        fr.set_threads(2)
        fr.set_names(fr.names())
        readers.append(fr)
    got, want = readers
    assert got.names() == want.names() \
        == ["ID", "PID", "Mvir", "X", "Y", "Z", "VX"]
    assert got.header() == want.header()
    assert got.blocks() == want.blocks()
    assert (got.blocks() > 1) == (block_size is not None)
    names = ["ID", "Mvir", "X", "VX"]
    dtypes = [np.int64, np.float32, np.float32, np.float32]
    rows = 0
    for b in range(got.blocks()):
        a, r = got.block(b, names, dtypes), want.block(b, names, dtypes)
        for name in names:
            same_bits(a[name], r[name])
        rows += len(a["ID"])
    assert rows == 500 and a["ID"][-1] == (1 << 53) + 500
    for fr in readers:
        fr.close()


def test_text_reader_from_bytes():
    data = b"# h\n1 2.5 x\n3 4.5 y\n\n5 6.5 z\n"
    outs = []
    for mod in (text, ref_text):
        r = mod.open_from_bytes(data)
        r.set_names(["a", "b", "c"])
        outs.append(r.block(0, ["a", "b"], [np.int64, np.float64]))
    for k in outs[1]:
        same_bits(outs[0][k], outs[1][k])
    np.testing.assert_array_equal(outs[0]["a"], [1, 3, 5])


def test_name_index_and_config(tmp_path):
    idx_file = tmp_path / "names.txt"
    idx_file.write_text("id ID haloid\nmvir Mvir M200c\n\nx X\n")
    got, want = name_index.open_index(str(idx_file)), \
        ref_name_index.open_index(str(idx_file))
    assert got.all_names == want.all_names
    for alias in ("ID", "HaloID", "m200C", "X", "nope"):
        assert got.standardize(alias) == want.standardize(alias)

    cfg_file = tmp_path / "run.config"
    cfg_file.write_text("[minh]\n# comment\nL = 250 # box\nEpsilon=0.001\n"
                        "MinParticles = 50\nMassName = mvir\nFlags = 1, 2\n")
    out = []
    for mod in (config, ref_config):
        v = mod.ConfigVars("minh")
        v.float("L", 0)
        v.float("Epsilon", 0)
        v.int("MinParticles", 0)
        v.string("MassName", "m")
        v.ints("Flags", [])
        v.bool("Verbose", False)
        mod.read_config(str(cfg_file), v)
        out.append({k: v[k] for k in ("L", "Epsilon", "MinParticles",
                                      "MassName", "Flags", "Verbose")})
    assert out[0] == out[1]
    assert out[0]["L"] == 250.0 and out[0]["Flags"] == [1, 2]
    bad = tmp_path / "bad.config"
    bad.write_text("[minh]\nNope = 1\n")
    for mod in (config, ref_config):
        with pytest.raises(mod.ConfigError):
            mod.read_config(str(bad), mod.ConfigVars("minh"))


def _mock(mod_snapshot, mod_minp, n_side, files, seed=8):
    rng = np.random.default_rng(seed)
    n = n_side ** 3
    hd = mod_minp.Header(z=0.0, scale=1.0, omega_m=0.3, omega_l=0.7,
                         h100=0.7, l=60.0, n_side=n_side, n_total=n)
    mod_snapshot.calc_uniform_mass(hd)
    pos = rng.uniform(0, 60, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 200, (n, 3)).astype(np.float32)
    order = np.array_split(rng.permutation(n), files)
    return mod_snapshot.MockSnapshot(hd, [pos[o] for o in order],
                                     [vel[o] for o in order],
                                     [o + 1 for o in order])


def _write_gadget(mods, dirname, n_side, files):
    lg, snap_mod, mp = mods
    gh = lg.LGadget2Header(time=1.0, box_size=60.0, omega0=0.3,
                           omega_lambda=0.7, hubble_param=0.7,
                           n_part_total=(0, n_side ** 3, 0, 0, 0, 0),
                           num_files=files)
    dirname.mkdir()
    lg.write_lgadget2(str(dirname), "snap_%03d.dat",
                      _mock(snap_mod, mp, n_side, files), gh)


PORT = (lgadget2, snapshot, minp)
REF = (ref_lgadget2, ref_snapshot, ref_minp)


def test_lgadget2_files_and_reads_across_packages(tmp_path):
    _write_gadget(PORT, tmp_path / "port", 8, 3)
    _write_gadget(REF, tmp_path / "ref", 8, 3)
    for f in sorted((tmp_path / "ref").iterdir()):
        assert f.read_bytes() == (tmp_path / "port" / f.name).read_bytes()
    # each package reads the other's files
    got = lgadget2.LGadget2Snapshot(str(tmp_path / "ref"))
    want = ref_lgadget2.LGadget2Snapshot(str(tmp_path / "port"))
    assert got.files() == want.files() == 3
    assert vars(got.header()) == vars(want.header())
    assert got.uniform_mass() == want.uniform_mass()
    for i in range(3):
        same_bits(got.read_x(i), want.read_x(i))
        same_bits(got.read_v(i), want.read_v(i))
        same_bits(got.read_id(i), want.read_id(i))
        assert got.raw_header(i) == want.raw_header(i)


@pytest.mark.parametrize("cells", [1, 2, 4])
def test_snapshot_grid(tmp_path, cells):
    _write_gadget(REF, tmp_path / "gadget", 8, 2)
    got = snapshot.Grid(lgadget2.LGadget2Snapshot(str(tmp_path / "gadget")),
                        cells)
    want = ref_snapshot.Grid(
        ref_lgadget2.LGadget2Snapshot(str(tmp_path / "gadget")), cells)
    assert got.files() == want.files() == cells ** 3
    for i in range(cells ** 3):
        same_bits(got.read_x(i), want.read_x(i))
        same_bits(got.read_v(i), want.read_v(i))
        same_bits(got.read_id(i), want.read_id(i))


def test_write_minp_and_minp_snapshot(tmp_path):
    _write_gadget(REF, tmp_path / "gadget", 8, 2)
    for name, (lg, snap_mod, _) in (("port", PORT), ("ref", REF)):
        (tmp_path / name).mkdir()
        snap_mod.write_minp(str(tmp_path / name), "%s_%d.minp", 2, 2, 0.001,
                            0.5, lg.LGadget2Snapshot(str(tmp_path / "gadget")))
    names = sorted(f.name for f in (tmp_path / "ref").iterdir())
    assert len(names) == 16
    for f in names:
        assert (tmp_path / "port" / f).read_bytes() \
            == (tmp_path / "ref" / f).read_bytes()
    got = snapshot.MinPSnapshot(str(tmp_path / "ref"), "%s_%d.minp")
    want = ref_snapshot.MinPSnapshot(str(tmp_path / "port"), "%s_%d.minp")
    assert got.files() == want.files() == 8
    assert vars(got.header()) == vars(want.header())
    for i in (0, 7):
        same_bits(got.read_x(i), want.read_x(i))
        same_bits(got.read_v(i), want.read_v(i))
        same_bits(got.read_id(i), want.read_id(i))
