"""The comparison that decides ``correct``, shown to fail.

Every cell is driven through a whole run at a small size on the CPU (the
port's plain versions stand in for its kernels): the run as it is comes
out correct; the control (the reference in the program's place, in
bfloat16) and each fault the cell can have, planted in the program's
timed path, come out not correct.  Each cell's format module
(``formats/<format>.py``) gives its small size (``small``) and its faults
(``faults``), so a new cell needs no change here."""

import importlib

import pytest

from _paths import ROOT

from harness import cell

SPEC = cell.spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def fmt(name):
    """The format module and the configuration of cell ``name``."""
    cfg = cell.config(SPEC, cell.cell(SPEC, name)["config"])
    return importlib.import_module("formats." + cfg["format"]), cfg


def faults(name) -> dict:
    """Fault name -> ``plant(monkeypatch)`` for cell ``name``'s traffic."""
    kind = cell.traffic(cell.cell(SPEC, name)["traffic"])["kind"]
    return fmt(name)[0].faults(kind)


FAULTS = [(name, fault) for name in CELLS for fault in sorted(faults(name))]


def run(name, tmp_path, program=None, seed=2 ** 31 + 7):
    module, cfg = fmt(name)
    result, checks, errors = cell.run_cell(
        name, seed, 0.3, False, "cpu", 0.0, ROOT, module.small(cfg),
        program, tmp_path / "work")
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


@pytest.mark.parametrize("name, fault", FAULTS)
def test_fault_is_not_correct(name, fault, monkeypatch, tmp_path):
    faults(name)[fault](monkeypatch)
    result, checks = run(name, tmp_path)
    assert not result["correct"], checks
