"""The port's writers against the checked-in golden digests: the four
writers of ``tests/test_goldens.py`` run with the port's container and
format modules in place of the reference's, in host mode and, for the
catalog, the boundary file and the snapshot, through the device route on
the CPU; every file must hash to the reference's digest."""

import hashlib
import types

import pytest

import test_goldens
from minnow_torch import core
from minnow_torch.core import types as core_types
from minnow_torch.formats import boundary, minh, minp
from minnow_torch.parallel.pipeline import BlockEncoder

# what test_goldens.py calls ``minnow``: the port's container API
PORT = types.SimpleNamespace(create=core.create, open=core.open,
                             UINT16_GROUP=core_types.UINT16_GROUP)


def _with(module, **changed):
    """``module``'s namespace with some names replaced."""
    return types.SimpleNamespace(**{**vars(module), **changed})


def _device_modules(devices):
    """The format modules with their writers on the device route: each
    format's ``create`` given an encoder."""
    enc = BlockEncoder(devices)
    return {
        "minh": _with(minh, create=lambda f: minh.create(f, encoder=enc)),
        "boundary": _with(boundary, create_boundary=lambda f:
                          boundary.create_boundary(f, encoder=enc)),
        "minp": _with(minp, create=lambda f: minp.create(f, encoder=enc)),
    }


def _digest_of(name, tmp_path, monkeypatch, modules):
    monkeypatch.setattr(test_goldens, "minnow", PORT)
    for attr, module in modules.items():
        monkeypatch.setattr(test_goldens, attr, module)
    fname = str(tmp_path / name)
    test_goldens._WRITERS[name](fname)
    with open(fname, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("name", test_goldens.GOLDENS)
def test_host_writers_give_the_golden_digests(name, tmp_path, monkeypatch):
    modules = {"minh": minh, "boundary": boundary, "minp": minp}
    assert _digest_of(name, tmp_path, monkeypatch, modules) \
        == test_goldens.GOLDENS[name]


@pytest.mark.parametrize("devices", ["cpu", ["cpu"] * 3],
                         ids=["one", "three shares"])
@pytest.mark.parametrize("name", ["catalog.minh", "boundary.minh",
                                  "snapshot.minp"])
def test_device_route_gives_the_golden_digests(name, devices, tmp_path,
                                               monkeypatch):
    assert _digest_of(name, tmp_path, monkeypatch,
                      _device_modules(devices)) == test_goldens.GOLDENS[name]


def test_the_reference_still_gives_them(tmp_path):
    """The digests are the reference's: its own test passes unpatched."""
    test_goldens.test_golden_bytes(tmp_path)
