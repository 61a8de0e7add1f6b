"""The container and minh fuzz of ``tests/test_fuzz.py`` on the port:
its generators and round-trip checks run with the port's container and
minh modules in place of the reference's, and each fuzzed file is
byte-identical to the one the reference writes from the same seed."""

import types

import pytest

import test_fuzz
from minnow_torch import core
from minnow_torch.cli import verify_minnow
from minnow_torch.core import types as core_types
from minnow_torch.formats import minh

PORT = types.SimpleNamespace(
    create=core.create, open=core.open,
    **{k: v for k, v in vars(core_types).items() if k.endswith("_GROUP")})


def _both(run, fname, tmp_path, monkeypatch, seed):
    """``run(dir, seed)`` with the reference's modules, then with the
    port's; returns the two files' bytes."""
    out = {}
    for who in ("ref", "port"):
        d = tmp_path / who
        d.mkdir()
        if who == "port":
            monkeypatch.setattr(test_fuzz, "minnow", PORT)
            monkeypatch.setattr(test_fuzz, "minh", minh)
        run(d, seed)
        out[who] = (d / fname).read_bytes()
    return out["ref"], out["port"]


@pytest.mark.parametrize("seed", range(20))
def test_container_fuzz_roundtrip(tmp_path, monkeypatch, seed):
    ref, port = _both(test_fuzz.test_container_fuzz_roundtrip, "fuzz.minnow",
                      tmp_path, monkeypatch, seed)
    assert port == ref and len(port) > 0


@pytest.mark.parametrize("seed", range(8))
def test_minh_fuzz_roundtrip(tmp_path, monkeypatch, seed):
    ref, port = _both(test_fuzz.test_minh_fuzz_roundtrip, "fuzz.minh",
                      tmp_path, monkeypatch, seed)
    assert port == ref and len(port) > 0


@pytest.mark.parametrize("seed", range(30))
def test_verify_never_crashes_on_corruption(tmp_path, seed):
    """The port's ``verify`` on the corrupted files of the reference's
    fuzz: a list of problems, never an exception, and the same verdict
    (problems or none) as the reference's."""
    from minnow_tpu.cli import verify_minnow as ref_verify

    test_fuzz.test_verify_never_crashes_on_corruption(tmp_path, seed)
    bad = str(tmp_path / "corrupt.minnow")
    problems = verify_minnow.verify(bad, deep=True)
    assert isinstance(problems, list)
    assert bool(problems) == bool(ref_verify.verify(bad, deep=True))
    assert not verify_minnow.verify(str(tmp_path / "victim.minnow"),
                                    deep=True)
