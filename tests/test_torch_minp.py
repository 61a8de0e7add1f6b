"""minp snapshots through minnow_torch on the CPU, against the JAX
package and the host codec, bitwise (tolerance zero: file bytes, and
float bit patterns):

* the port's ``BlockEncoder`` (the plain version of K1) writes minp files
  byte-identical to the host writer's and to the JAX ``BlockEncoder``'s,
  the ``clamp_q`` case of non-periodic groups included;
* ``minp_device.read_vectors`` (K2's plain version) equals
  ``minp.Reader.vectors()`` and the JAX ``read_vectors`` in every dither
  mode;
* ``convert_snapshot.to_minp`` writes the reference host converter's
  files, and ``--device`` refuses to run without CUDA.
"""

import os

import numpy as np
import pytest
import torch

from minnow_tpu.cli import convert_snapshot as ref_convert_snapshot
from minnow_tpu.core import spec
from minnow_tpu.formats import minp
from minnow_tpu.formats import minp_device as jax_minp_device
from minnow_tpu.ingest import lgadget2, snapshot
from minnow_tpu.parallel.pipeline import BlockEncoder as JaxBlockEncoder
from minnow_torch.cli import convert_snapshot
from minnow_torch.formats import minp_device
from minnow_torch.parallel.pipeline import BlockEncoder

# a non-periodic minp group whose largest value quantizes to exactly
# `pixels` (48,179 at dv 0.01): min -50, max 431.78207 (float32)
CLAMP_MIN, CLAMP_MAX, CLAMP_DV = -50.0, 431.7820739746094, 0.01


@pytest.mark.parametrize("periodic", [True, False])
def test_clamp_q_block_matches_spec_and_jax(periodic):
    """x == high (q == pixels) with clamp_q: re-encoded on the host with
    the clamp, as the reference does; the bytes change with it."""
    rng = np.random.default_rng(31)
    n = 1000
    low, high = -50.0, 75.0
    pixels = spec.float_group_pixels(low, high, 0.1)
    x = rng.uniform(low, high, (2, n)).astype(np.float32)
    x[0, 17] = high
    kw = dict(periodic=periodic)
    got = BlockEncoder("cpu").encode_float_blocks(x, low, high, pixels,
                                                  clamp_q=True, **kw)
    ref = JaxBlockEncoder().encode_float_blocks(x, low, high, pixels,
                                                clamp_q=True, **kw)
    unclamped = BlockEncoder("cpu").encode_float_blocks(x, low, high,
                                                        pixels, **kw)
    for i in range(2):
        want = spec.encode_float_block(x[i], low, high, pixels,
                                       clamp_q=True, **kw)[:3]
        assert (got.payloads[i], got.mins[i], got.bits[i]) == want, i
        assert unclamped.payloads[i] == spec.encode_float_block(
            x[i], low, high, pixels, **kw)[0], i
    assert got.payloads == ref.payloads
    assert got.payloads[0] != unclamped.payloads[0]
    assert got.payloads[1] == unclamped.payloads[1]
    np.testing.assert_array_equal(got.sizes, ref.sizes)
    np.testing.assert_array_equal(got.offsets, ref.offsets)
    assert got.total_bytes() == ref.total_bytes() == sum(map(len,
                                                             got.payloads))


def _vectors(rng, n_side, l, periodic):
    """Positions in [0, l) with some near both edges, or velocity-like
    values holding the clamp case on axis 0."""
    n = n_side ** 3
    if periodic:
        vec = rng.uniform(0, l, (n, 3)).astype(np.float32)
        vec[:8, 1] = l - rng.uniform(0, 1e-4, 8)
        vec[8:16, 2] = rng.uniform(0, 1e-4, 8)
        return vec
    vec = rng.normal(0, 100, (n, 3)).astype(np.float32)
    vec[:, 0] = rng.uniform(CLAMP_MIN, CLAMP_MAX, n)
    vec[3, 0], vec[n // 2, 0] = CLAMP_MIN, CLAMP_MAX
    return vec


def _write(fname, vec, n_side, sub_cells, periodic, encoder=None):
    l = 100.0
    hd = minp.Header(z=0.5, scale=2 / 3, omega_m=0.3, omega_l=0.7, h100=0.7,
                     l=l, n_side=n_side, n_total=n_side ** 3)
    w = minp.Writer(fname, encoder=encoder)
    w.header(hd, b"\x63", minp.Cell(0, 1, sub_cells),
             0.01 if periodic else CLAMP_DV, periodic)
    w.vectors(vec)
    w.close()
    with open(fname, "rb") as f:
        return f.read()


@pytest.mark.parametrize("periodic", [True, False])
def test_minp_writer_with_port_encoder(tmp_path, periodic):
    rng = np.random.default_rng(42 + periodic)
    n_side, sub_cells = 8, 2
    vec = _vectors(rng, n_side, 100.0, periodic)
    files = [_write(str(tmp_path / ("%s.minp" % name)), vec, n_side,
                    sub_cells, periodic, enc)
             for name, enc in (("host", None), ("port", BlockEncoder("cpu")),
                               ("jax", JaxBlockEncoder()))]
    assert files[1] == files[0]
    assert files[2] == files[0]
    if not periodic:
        # the clamp case is in the file: one block's bytes need it
        blocks = minp.split_sub_cells(vec, sub_cells)[:, :, 0]
        hi = np.nextafter(np.float32(CLAMP_MAX), np.float32(2 * CLAMP_MAX))
        pixels = spec.float_group_pixels(CLAMP_MIN, hi, CLAMP_DV)
        differ = [spec.encode_float_block(b, CLAMP_MIN, hi, pixels)[0]
                  != spec.encode_float_block(b, CLAMP_MIN, hi, pixels,
                                             clamp_q=True)[0]
                  for b in blocks]
        assert sum(differ) == 1


# (n_side, sub_cells, periodic): sub-cells of 64 and one of 32^3
FILES = [(8, 2, True), (8, 2, False), (32, 1, True)]
MODES = [("none", 0), ("midpoint", 0), ("uniform", 0), ("uniform", 3)]


@pytest.mark.parametrize("dither,seed", MODES)
@pytest.mark.parametrize("n_side,sub_cells,periodic", FILES)
def test_read_vectors_matches_host_and_jax(tmp_path, n_side, sub_cells,
                                           periodic, dither, seed):
    rng = np.random.default_rng(n_side + sub_cells + periodic)
    fname = str(tmp_path / "p.minp")
    _write(fname, _vectors(rng, n_side, 100.0, periodic), n_side, sub_cells,
           periodic)
    r = minp.open(fname, dither=dither, seed=seed)
    try:
        host = r.vectors()
        got = minp_device.read_vectors(r, "cpu")
        jax = jax_minp_device.read_vectors(r)
    finally:
        r.close()
    assert got.dtype == torch.float32 and got.shape == (n_side ** 3, 3)
    got = got.numpy()
    np.testing.assert_array_equal(got.view(np.uint32), host.view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32), jax.view(np.uint32))


def test_read_vectors_takes_a_mode_other_than_the_readers(tmp_path):
    rng = np.random.default_rng(5)
    fname = str(tmp_path / "p.minp")
    _write(fname, _vectors(rng, 8, 100.0, True), 8, 2, True)
    with minp.open(fname, dither="none") as r:
        got = minp_device.read_vectors(r, "cpu", dither="uniform", seed=9)
    with minp.open(fname, dither="uniform", seed=9) as r:
        want = r.vectors()
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def write_gadget(d, n_side=8, l=50.0, seed=17):
    """An LGadget-2 fileset of one file (tests/test_cli.py's)."""
    rng = np.random.default_rng(seed)
    n = n_side ** 3
    hd = minp.Header(z=0.0, scale=1.0, omega_m=0.3, omega_l=0.7, h100=0.7,
                     l=l, n_side=n_side, n_total=n)
    snapshot.calc_uniform_mass(hd)
    snap = snapshot.MockSnapshot(
        hd, [rng.uniform(0, l * 0.99, (n, 3)).astype(np.float32)],
        [rng.normal(0, 50, (n, 3)).astype(np.float32)],
        [rng.permutation(n) + 1])
    os.makedirs(d)
    gh = lgadget2.LGadget2Header(time=1.0, box_size=l, omega0=0.3,
                                 omega_lambda=0.7, hubble_param=0.7,
                                 n_part_total=(0, n, 0, 0, 0, 0))
    lgadget2.write_lgadget2(d, "snap_%03d.dat", snap, gh)
    return d


def _same_dirs(a, b, count):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) == count
    for f in names:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def test_to_minp_equals_reference_host_converter(tmp_path):
    gdir = write_gadget(str(tmp_path / "gadget"))
    host, port, via_main = (tmp_path / d for d in ("host", "port", "main"))
    for d in (host, port, via_main):
        d.mkdir()
    args = ["2", "2", "0.001", "0.01"]
    ref_convert_snapshot.main(["to_minp", gdir, str(host), *args])
    convert_snapshot.to_minp(gdir, str(port), 2, 2, 0.001, 0.01, "cpu")
    convert_snapshot.main(["to_minp", gdir, str(via_main), *args])
    _same_dirs(port, host, 16)
    _same_dirs(via_main, host, 16)
    for name in ("x_3.minp", "v_5.minp"):
        with minp.open(str(port / name)) as r:
            np.testing.assert_array_equal(
                minp_device.read_vectors(r, "cpu").numpy().view(np.uint32),
                r.vectors().view(np.uint32))

    # to_lgadget2 is the reference's host conversion
    back, ref_back = tmp_path / "back", tmp_path / "ref_back"
    back.mkdir()
    ref_back.mkdir()
    convert_snapshot.main(["to_lgadget2", str(port), "%s_%d.minp",
                           str(back)])
    ref_convert_snapshot.main(["to_lgadget2", str(host), "%s_%d.minp",
                               str(ref_back)])
    _same_dirs(back, ref_back, 8)


def test_device_flag_needs_cuda(tmp_path, monkeypatch):
    gdir = write_gadget(str(tmp_path / "gadget"))
    out = tmp_path / "out"
    out.mkdir()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert_snapshot.main(["to_minp", gdir, str(out), "2", "2", "0.001",
                               "0.01", "--device"])
    assert not list(out.iterdir())
    with pytest.raises(SystemExit):
        convert_snapshot.main(["to_minp", gdir, str(out)])
