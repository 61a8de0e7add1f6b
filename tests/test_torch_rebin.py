"""The device route of the snapshot re-binning on the CPU (the plain
version of ``csrc/rebin.cu``), bitwise:

* ``convert_snapshot.to_minp`` with a device (``snapshot.Grid(device=)``,
  ``minp.Writer.vectors`` on a tensor, ``BlockEncoder`` on a tensor)
  writes the files of host mode and of the JAX package's converter, at
  one and two file cells and sub-cells, the IDs shuffled across the
  source files; one ``rebin.Batch.add`` a source file and batch of file
  cells, both vector kinds at once, and each ``grid.scatter`` span says
  the device route ran; under a smaller budget the batches hold fewer
  cells, each built once;
* one index function for both routes, equal to the JAX package's;
* an ID out of range raises the host route's ``ValueError``, and so does
  an ID given twice, in the batch that holds it;
* ``BlockEncoder.encode_float_blocks`` gives the same ``EncodedBlocks``
  for a tensor and for its numpy copy, a block sent to the host encoder
  included.
"""

import os
import time

import numpy as np
import pytest
import torch

from minnow_tpu.cli import convert_snapshot as ref_convert_snapshot
from minnow_tpu.ingest import snapshot as ref_snapshot
from minnow_torch.cli import convert_snapshot
from minnow_torch.core import spec
from minnow_torch.formats import minp
from minnow_torch.ingest import lgadget2, snapshot
from minnow_torch.ops import rebin
from minnow_torch.parallel import pipeline
from minnow_torch.parallel.pipeline import BlockEncoder
from minnow_torch.utils import profiling


def _header(n_side, l=50.0):
    hd = minp.Header(z=0.0, scale=1.0, omega_m=0.3, omega_l=0.7, h100=0.7,
                     l=l, n_side=n_side, n_total=n_side ** 3)
    snapshot.calc_uniform_mass(hd)
    return hd


def _mock(n_side, files, seed, l=50.0):
    """A snapshot of ``files`` files, the IDs shuffled across them."""
    rng = np.random.default_rng(seed)
    n = n_side ** 3
    parts = np.array_split(rng.permutation(n), files)
    x = rng.uniform(0, l * 0.99, (n, 3)).astype(np.float32)
    v = rng.normal(0, 50, (n, 3)).astype(np.float32)
    return snapshot.MockSnapshot(_header(n_side, l), [x[p] for p in parts],
                                 [v[p] for p in parts],
                                 [p + 1 for p in parts])


def _write_gadget(d, n_side, files, seed):
    snap = _mock(n_side, files, seed)
    os.makedirs(d)
    gh = lgadget2.LGadget2Header(time=1.0, box_size=snap.hd.l, omega0=0.3,
                                 omega_lambda=0.7, hubble_param=0.7,
                                 n_part_total=(0, n_side ** 3, 0, 0, 0, 0),
                                 num_files=files)
    lgadget2.write_lgadget2(d, "snap_%03d.dat", snap, gh)
    return d


def _same_dirs(a, b, count):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) == count
    for f in names:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def _cells_a_batch(monkeypatch, n_side, cells, per_batch):
    """Give the device route's batches ``per_batch`` file cells (None: no
    limit); record each batch's (first, count)."""
    made = []

    class Recorded(rebin.Batch):
        def __init__(self, *args):
            super().__init__(*args)
            made.append((self.first, self.count))

    monkeypatch.setattr(rebin, "Batch", Recorded)
    if per_batch is not None:
        budget = per_batch * rebin.batch_bytes(n_side, cells, 1)
        monkeypatch.setattr(snapshot, "device_budget", lambda dev: budget)
    return made


@pytest.mark.parametrize("files", [1, 3])
@pytest.mark.parametrize("sub_cells", [1, 2])
@pytest.mark.parametrize("file_cells", [1, 2])
def test_device_route_writes_host_modes_files(tmp_path, monkeypatch,
                                              file_cells, sub_cells, files):
    gdir = _write_gadget(str(tmp_path / "g"), 8, files,
                         seed=10 * file_cells + sub_cells + files)
    dev, host, ref = (tmp_path / d for d in ("dev", "host", "ref"))
    for d in (dev, host, ref):
        d.mkdir()
    args = (file_cells, sub_cells, 0.001, 0.01)
    made = _cells_a_batch(monkeypatch, 8, file_cells, None)
    calls = rebin.REBIN_LAUNCHES
    t0 = time.perf_counter()
    convert_snapshot.to_minp(gdir, str(dev), *args, "cpu")
    spans, dropped = profiling.records(t0)
    # one batch of every cell: one call a source file, both kinds at once
    assert made == [(0, file_cells ** 3)]
    assert rebin.REBIN_LAUNCHES - calls == files
    scatters = [s for s in spans if s.name == "grid.scatter"]
    assert not dropped and len(scatters) == files
    assert all(s.counts == {"device": 1} for s in scatters)

    t0 = time.perf_counter()
    convert_snapshot.to_minp(gdir, str(host), *args)
    spans, _ = profiling.records(t0)
    assert rebin.REBIN_LAUNCHES - calls == files
    assert all(s.counts == {} for s in spans if s.name == "grid.scatter")
    ref_convert_snapshot.main(["to_minp", gdir, str(ref),
                               *(str(a) for a in args)])
    _same_dirs(dev, host, 2 * file_cells ** 3)
    _same_dirs(dev, ref, 2 * file_cells ** 3)


@pytest.mark.parametrize("per_batch,batches", [
    (1, [(i, 1) for i in range(8)]), (3, [(0, 3), (3, 3), (6, 2)]),
    (7, [(0, 7), (7, 1)]), (8, [(0, 8)])])
def test_device_route_holds_a_batch_of_cells(tmp_path, monkeypatch,
                                             per_batch, batches):
    """Under a budget of ``per_batch`` cells the card holds one batch of
    cells at a time, each built once (every source file read and copied
    again), and the files are host mode's."""
    files = 3
    gdir = _write_gadget(str(tmp_path / "g"), 8, files, seed=per_batch)
    dev, host = tmp_path / "dev", tmp_path / "host"
    dev.mkdir()
    host.mkdir()
    args = (2, 2, 0.001, 0.01)
    made = _cells_a_batch(monkeypatch, 8, 2, per_batch)
    calls = rebin.REBIN_LAUNCHES
    t0 = time.perf_counter()
    convert_snapshot.to_minp(gdir, str(dev), *args, "cpu")
    spans, dropped = profiling.records(t0)
    assert made == batches
    assert rebin.REBIN_LAUNCHES - calls == files * len(batches)
    names = [s.name for s in spans]
    assert not dropped
    assert names.count("grid.scatter") == files * len(batches)
    assert names.count("lgadget2.read") == 3 * files * len(batches)
    convert_snapshot.to_minp(gdir, str(host), *args)
    _same_dirs(dev, host, 16)


@pytest.mark.parametrize("n_side,cells", [(8, 1), (8, 2), (12, 3), (16, 4)])
def test_cell_index_is_the_references(n_side, cells):
    """One index function for both routes, on numpy and on tensors, equal
    to the JAX package's ``Grid._cell_index``."""
    snap = _mock(n_side, 1, seed=n_side + cells)
    ids = np.random.default_rng(cells).permutation(n_side ** 3)
    want = ref_snapshot.Grid(snap, cells)._cell_index(ids)
    host = snapshot.Grid(snap, cells)._cell_index(ids)
    tensors = rebin.cell_index(torch.from_numpy(ids), n_side, cells)
    for got in (host, [t.numpy() for t in tensors]):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("per_batch", [None, 1])
@pytest.mark.parametrize("cells", [1, 2, 4])
def test_device_grid_equals_host_grid(monkeypatch, cells, per_batch):
    """The index arithmetic of both routes, and the vectors' bits (NaN
    payloads included), on a snapshot whose files hold uneven shares."""
    snap = _mock(8, 5, seed=cells)
    snap.v[2][3] = np.array([0x7FC01234, 0xFFA00001, 0x80000000],
                            np.uint32).view(np.float32)
    _cells_a_batch(monkeypatch, 8, cells, per_batch)
    host = snapshot.Grid(snap, cells)
    dev = snapshot.Grid(snap, cells, device="cpu")
    for read_host, read_dev in ((host.read_x, dev.read_x),
                                (host.read_v, dev.read_v)):
        for i in range(cells ** 3):
            got = read_dev(i)
            assert torch.is_tensor(got) and got.shape == (512 // cells ** 3,
                                                          3)
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          read_host(i).view(np.uint32))


@pytest.mark.parametrize("bad", [0, 513, -7, -2 ** 63])
@pytest.mark.parametrize("device", [None, "cpu"])
def test_an_id_out_of_range_raises(bad, device):
    snap = _mock(8, 2, seed=3)
    snap.ids[1][4] = bad
    grid = snapshot.Grid(snap, 2, device=device)
    with pytest.raises(ValueError, match="ID out of range for NSide=8"):
        grid.read_x(0)


@pytest.mark.parametrize("same_file", [True, False])
def test_an_id_given_twice_raises_on_the_device_route(same_file):
    snap = _mock(8, 2, seed=4)
    # particle 5 of file 0 takes the ID of another particle of file 0, or
    # of file 1's first
    snap.ids[0][5] = snap.ids[0 if same_file else 1][0]
    grid = snapshot.Grid(snap, 1, device="cpu")
    with pytest.raises(ValueError, match=r"two particles have one ID "
                       r"\(NSide=8\)"):
        grid.read_v(0)


def test_an_id_given_twice_raises_in_its_cells_batch(monkeypatch):
    """A batch is checked before its cells are read: cells of the batches
    before the one that holds the shared place read."""
    snap = _mock(8, 2, seed=6)
    _cells_a_batch(monkeypatch, 8, 2, 2)
    # ID 448 (0-based 447: x 7, y 7, z 6) lies in cell 7, of the last
    # batch (cells 6 and 7); another particle takes it too
    twin = 448
    f = next(f for f, ids in enumerate(snap.ids) if twin in ids)
    snap.ids[1 - f][0] = twin
    grid = snapshot.Grid(snap, 2, device="cpu")
    for i in range(6):
        grid.read_x(i)
    with pytest.raises(ValueError, match="two particles have one ID"):
        grid.read_x(6)


def test_batch_refuses_what_the_kernel_does_not_take():
    ids = torch.arange(1, 9)
    xv = torch.zeros(8, 3)
    with pytest.raises(ValueError, match="cells do not divide"):
        rebin.Batch(2, 3, 0, 1, "cpu")
    with pytest.raises(ValueError, match=r"cells \[7, 9\) are not of the 8"):
        rebin.Batch(2, 2, 7, 2, "cpu")
    batch = rebin.Batch(2, 2, 0, 8, "cpu")
    with pytest.raises(ValueError, match="x must have shape"):
        batch.add(ids, xv[:7], xv)
    with pytest.raises(TypeError, match="ids must be torch.int64"):
        batch.add(ids.int(), xv, xv)
    batch.add(ids, xv + 1, xv + 2)
    batch.check()
    assert bool((batch.x == 1).all()) and bool((batch.v == 2).all())
    assert batch.marks.tolist() == [0xFF]
    # cells 2 and 3 alone: the other six particles pass by
    batch = rebin.Batch(2, 2, 2, 2, "cpu")
    batch.add(ids, xv + ids[:, None], xv)
    batch.check()
    assert batch.x[:, 0, 0].tolist() == [3, 4]
    assert batch.marks.tolist() == [0b11]


@pytest.mark.parametrize("cells,count", [(1, 1), (2, 3), (4, 64)])
def test_batch_marks_a_bit_a_place(cells, count):
    """The marks are a bit a place of the batch, in 32-bit words (the top
    bit of a word included), and take what ``batch_bytes`` counts; a
    place reached again in a later call is found."""
    n_side = 8
    places = count * (n_side // cells) ** 3
    batch = rebin.Batch(n_side, cells, 0, count, "cpu")
    assert rebin.batch_bytes(n_side, cells, count) == sum(
        t.numel() * t.element_size() for t in (batch.x, batch.v,
                                               batch.marks))
    ids = torch.from_numpy(np.random.default_rng(count).permutation(
        n_side ** 3) + 1)
    xv = torch.zeros(len(ids), 3)
    batch.add(ids, xv, xv)
    batch.check()
    bits = np.unpackbits(batch.marks.numpy().view(np.uint8),
                         bitorder="little")
    assert bits[:places].all() and not bits[places:].any()
    batch.add(ids[-1:], xv[:1], xv[:1])
    with pytest.raises(ValueError, match="two particles have one ID"):
        batch.check()


@pytest.mark.parametrize("sub_cells", [1, 2, 4])
def test_split_axes_is_split_sub_cells_axis_first(sub_cells):
    vec = np.random.default_rng(sub_cells).normal(size=(512, 3)).astype(
        np.float32)
    got = minp.split_axes(torch.from_numpy(vec), sub_cells)
    assert got.is_contiguous()
    np.testing.assert_array_equal(
        got.numpy(), minp.split_sub_cells(vec, sub_cells).transpose(2, 0, 1))


def _write(path, vec, periodic, encoder):
    w = minp.Writer(str(path), encoder=encoder)
    w.header(_header(8, 100.0), b"\x63", minp.Cell(0, 1, 2),
             0.01 if periodic else 0.5, periodic)
    w.vectors(vec)
    w.close()
    return path.read_bytes()


@pytest.mark.parametrize("periodic", [True, False])
def test_minp_writer_takes_a_tensor(tmp_path, periodic):
    rng = np.random.default_rng(8 + periodic)
    vec = (rng.uniform(0, 100, (512, 3)) if periodic
           else rng.normal(0, 30, (512, 3))).astype(np.float32)
    want = _write(tmp_path / "host.minp", vec, periodic, None)
    got = _write(tmp_path / "tensor.minp", torch.from_numpy(vec), periodic,
                 BlockEncoder("cpu"))
    assert got == want
    with pytest.raises(TypeError, match="needs the writer's encoder"):
        _write(tmp_path / "none.minp", torch.from_numpy(vec), periodic, None)


# a non-periodic group whose largest value quantizes to exactly `pixels`
# (48,179 at 0.01): tests/test_torch_minp.py's clamp case
CLAMP_MIN, CLAMP_MAX, CLAMP_DV = -50.0, 431.7820739746094, 0.01


@pytest.mark.parametrize("periodic,clamp_q", [(True, False), (False, True),
                                              (False, False)])
def test_encode_float_blocks_of_a_tensor(periodic, clamp_q):
    rng = np.random.default_rng(21 + periodic + 2 * clamp_q)
    low, high = np.float32(CLAMP_MIN), np.float32(CLAMP_MAX)
    pixels = spec.float_group_pixels(low, high, CLAMP_DV)
    x = rng.uniform(low, high, (4, 999)).astype(np.float32)
    x[1, 17] = high  # its pixel is `pixels`: clamp_q sends it to the host
    x[2, 3] = np.nan  # never certified: the host encoder takes it
    enc = BlockEncoder("cpu")
    kw = dict(periodic=periodic, clamp_q=clamp_q)
    counts = [pipeline.HOST_BLOCKS]
    want = enc.encode_float_blocks(x, low, high, pixels, **kw)
    counts.append(pipeline.HOST_BLOCKS)
    got = enc.encode_float_blocks(torch.from_numpy(x), low, high, pixels,
                                  **kw)
    counts.append(pipeline.HOST_BLOCKS)
    # the NaN block, and the block at `pixels` where it is out of range
    # (periodic) or clamped
    hosted = 2 if periodic or clamp_q else 1
    assert np.diff(counts).tolist() == [hosted, hosted]
    assert got.payloads == want.payloads
    for name in ("mins", "bits", "lens"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("read,cut", [("read_x", 30), ("read_v", 12 * 64),
                                      ("read_id", 8)])
def test_a_short_lgadget2_file_raises(tmp_path, read, cut):
    """Each block is read straight into its array; a file that ends
    inside the block raises."""
    gdir = _write_gadget(str(tmp_path / "g"), 4, 1, seed=2)
    snap = lgadget2.LGadget2Snapshot(gdir)
    want = getattr(snap, read)(0)
    name = snap.filenames[0]
    data = open(name, "rb").read()
    # where the block's data end: each record is guarded by two marks
    ends = {"read_x": 8 + 256 + 4 + 12 * 64, "read_v": 8 + 256 + 12 + 24 * 64,
            "read_id": len(data) - 4}[read]
    with open(name, "wb") as f:
        f.write(data[:ends - cut])
    with pytest.raises(lgadget2.CorruptionError, match="ends inside a block"):
        getattr(snap, read)(0)
    with open(name, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(getattr(snap, read)(0), want)


def test_an_empty_lgadget2_file_reads_empty(tmp_path):
    snap = _mock(4, 2, seed=3)
    for group in (snap.x, snap.v, snap.ids):
        group[0] = np.concatenate([group[0], group[1]])
        group[1] = group[1][:0]
    os.makedirs(tmp_path / "g")
    gh = lgadget2.LGadget2Header(time=1.0, box_size=snap.hd.l, omega0=0.3,
                                 omega_lambda=0.7, hubble_param=0.7,
                                 n_part_total=(0, 64, 0, 0, 0, 0),
                                 num_files=2)
    lgadget2.write_lgadget2(str(tmp_path / "g"), "snap_%03d.dat", snap, gh)
    got = lgadget2.LGadget2Snapshot(str(tmp_path / "g"))
    for read, shape in (("read_x", (0, 3)), ("read_v", (0, 3)),
                        ("read_id", (0,))):
        assert getattr(got, read)(1).shape == shape
        assert len(getattr(got, read)(0)) == 64
