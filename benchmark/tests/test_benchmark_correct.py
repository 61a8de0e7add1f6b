"""The comparison that decides ``correct``, shown to fail.

Every cell is driven through a whole run at a small size on the CPU (the
port's plain versions stand in for its kernels): the run as it is comes
out correct; the control (the reference in the program's place, in
bfloat16) and each fault the cell can have, planted in the program's
timed path, come out not correct."""

import os

import numpy as np
import pytest
import torch

from _paths import ROOT

from harness import cell
from minnow_torch.cli import convert_snapshot, text_to_minh
from minnow_torch.formats import minh_device, minp_device

SPEC = cell.spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
SMALL = {"minh_L250": lambda c: {"rows": 1500},
         "minp_L250": lambda c: {"n_side": 32}}


def run(name, tmp_path, program=None, seed=2 ** 31 + 7):
    work = cell.cell(SPEC, name)
    cfg = cell.config(SPEC, work["config"])
    result, checks, errors = cell.run_cell(
        name, seed, 0.3, False, "cpu", 0.0, ROOT,
        SMALL[work["config"]](cfg), program, tmp_path / "work")
    return result, checks


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tmp_path):
    result, checks = run(name, tmp_path)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert all(v == 0 for v, _ in checks.values())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, tmp_path):
    result, checks = run(name, tmp_path, lambda wl, kept: wl.control())
    assert not result["correct"]
    assert max(v - lim for v, lim in checks.values()) > 0


def _flip(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 1]))


def _halve(path):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


def _altered(x):
    if isinstance(x, torch.Tensor):
        x = x.clone()
        x.view(-1)[x.numel() // 2] += 1
        return x
    x = x.copy()
    x.reshape(-1)[x.size // 2] += 1
    return x


def _half(x):
    return x[: len(x) // 2]


def _unchanged(x):
    return torch.zeros_like(x) if isinstance(x, torch.Tensor) \
        else np.zeros_like(x)


def _broken_read(fault):
    def read_vectors(reader, device=None, **kw):
        return fault(real_vectors(reader, device, **kw))

    def read_floats(reader, names, device=None, **kw):
        return {n: fault(a) for n, a in
                real_floats(reader, names, device, **kw).items()}
    return read_vectors, read_floats


real_vectors = minp_device.read_vectors
real_floats = minh_device.read_floats
real_convert = text_to_minh.convert_file
real_to_minp = convert_snapshot.to_minp

READ_FAULTS = {"altered": _altered, "half": _half, "unchanged": _unchanged}
CONVERT_FAULTS = {"altered": _flip, "half": _halve, "unchanged": None}


def _broken_convert(fault):
    def convert_file(*args, **kw):
        out = args[5]
        timed = os.path.basename(os.path.dirname(out)) == "out"
        if timed and fault is None:
            return  # nothing written: the output stays as it was
        real_convert(*args, **kw)
        if timed:  # set-up's own conversions stay sound
            fault(out)

    def to_minp(in_dir, out_dir, *args):
        timed = os.path.basename(out_dir).isdigit()
        if timed and fault is None:
            return
        real_to_minp(in_dir, out_dir, *args)
        if timed:  # set-up's own conversion stays sound
            fault(os.path.join(out_dir, "x_0.minp"))
    return convert_file, to_minp


@pytest.mark.parametrize("fault", sorted(READ_FAULTS))
@pytest.mark.parametrize("name", [n for n in CELLS if n.endswith(".read")])
def test_read_fault_is_not_correct(name, fault, monkeypatch, tmp_path):
    vectors, floats = _broken_read(READ_FAULTS[fault])
    monkeypatch.setattr(minp_device, "read_vectors", vectors)
    monkeypatch.setattr(minh_device, "read_floats", floats)
    result, checks = run(name, tmp_path)
    assert not result["correct"], checks


@pytest.mark.parametrize("fault", sorted(CONVERT_FAULTS))
@pytest.mark.parametrize("name",
                         [n for n in CELLS if n.endswith(".convert")])
def test_convert_fault_is_not_correct(name, fault, monkeypatch,
                                      tmp_path):
    convert_file, to_minp = _broken_convert(CONVERT_FAULTS[fault])
    monkeypatch.setattr(text_to_minh, "convert_file", convert_file)
    monkeypatch.setattr(convert_snapshot, "to_minp", to_minp)
    result, checks = run(name, tmp_path)
    assert not result["correct"], checks
