"""The port's minh writer refuses a malformed row-block in host mode and
on the device route alike: ``minh.create(f, encoder=...)`` runs the same
argument checks as the host writer before it encodes anything."""

import numpy as np
import pytest

from minnow_torch.formats import minh
from minnow_torch.parallel.pipeline import BlockEncoder

NAMES = ["x", "id", "mvir", "upid"]
COLS = [minh.Column(type=minh.Float, low=0, high=100, dx=0.01),
        minh.Column(type=minh.Int),
        minh.Column(type=minh.Float, log=1, low=5, high=16, dx=0.001),
        minh.Column(type=minh.Int64)]


def _row_block(n, rng):
    return [rng.uniform(0, 99, n).astype(np.float32),
            np.arange(n, dtype=np.int64) + (1 << 40),
            np.float32(10.0 ** rng.uniform(9, 14, n)),
            rng.integers(-(1 << 62), 1 << 62, n)]


def _one_column_too_few(rng):
    return _row_block(64, rng)[:-1]  # the raw Int64 column left out


def _short_int_columns(rng):
    cols = _row_block(64, rng)
    cols[1] = cols[1][:-1]
    return cols


@pytest.mark.parametrize("make", [_one_column_too_few, _short_int_columns],
                         ids=["one column too few", "short int columns"])
@pytest.mark.parametrize("device", [None, "cpu"], ids=["host", "device"])
def test_a_malformed_row_block_raises(make, device, tmp_path):
    enc = None if device is None else BlockEncoder(device)
    w = minh.create(str(tmp_path / "out.minh"), encoder=enc)
    w.header(NAMES, "malformed row-blocks", COLS)
    w.geometry(100, 0, 0)
    rng = np.random.default_rng(5)
    w.block(_row_block(32, rng))
    with pytest.raises(ValueError):
        w.block(make(rng))
    w.close()
