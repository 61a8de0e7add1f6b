"""The port's one-shot kernel certification (``ops.selfcheck``): it passes
on the CPU's plain versions against ``core.spec``, and a divergence
raises, is cached, and is never answered by another route."""

import threading

import numpy as np
import pytest
import torch

from minnow_torch.formats import device_common
from minnow_torch.ops import decode, encode, selfcheck
from minnow_torch.parallel.pipeline import BlockEncoder


@pytest.fixture(autouse=True)
def fresh_verdicts():
    selfcheck.reset()
    yield
    selfcheck.reset()


def _flip_first_word(fn):
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        out = out.clone()
        bits = out.view(torch.int32) if out.dtype == torch.float32 else out
        bits.view(-1)[0] ^= 1
        return out
    return wrapped


@pytest.mark.parametrize("family", selfcheck.FAMILIES)
def test_families_pass_on_the_cpu_and_are_cached(family, monkeypatch):
    assert selfcheck.kernel_ok(family, "cpu") is True
    calls = []
    monkeypatch.setitem(selfcheck._CHECKS, family,
                        lambda dev: calls.append(dev))
    assert selfcheck.kernel_ok(family, torch.device("cpu")) is True
    assert calls == []  # the verdict of the first call stands
    selfcheck.reset()
    assert selfcheck.kernel_ok(family, "cpu") is True
    assert calls == [torch.device("cpu")]


def test_unknown_family_and_missing_card(monkeypatch):
    with pytest.raises(ValueError, match="unknown kernel family"):
        selfcheck.kernel_ok("pack", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        selfcheck.kernel_ok("encode")


# what to break -> the family that must catch it and a word of its report
DIVERGENCES = [
    ("encode", encode, "pack_float_plain", "K1 payload"),
    ("encode", encode, "delta_pack_int_plain", "K3 payload"),
    # K3's stats and plan launches: a minimum one off
    ("encode", encode, "int_stats_plain", "K3 plan"),
    ("encode", encode, "int_plan_plain", "K3 plan"),
    ("decode", decode, "decode_int_plain", "K2 none decode"),
    ("decode_uniform", decode, "decode_float_plain", "K2 uniform decode"),
]


@pytest.mark.parametrize("family,mod,name,word", DIVERGENCES)
def test_a_divergence_raises_names_the_family_and_is_cached(
        family, mod, name, word, monkeypatch):
    monkeypatch.setattr(mod, name, _flip_first_word(getattr(mod, name)))
    with pytest.raises(selfcheck.SelfCheckError) as e:
        selfcheck.kernel_ok(family, "cpu")
    assert repr(family) in str(e.value) and word in str(e.value)
    assert "first at 0" in str(e.value) or "block 0" in str(e.value)
    # repaired or not, the process keeps its verdict: no second check
    monkeypatch.undo()
    with pytest.raises(selfcheck.SelfCheckError, match=word):
        selfcheck.kernel_ok(family, "cpu")
    # the other families keep their own verdicts
    other = next(f for f in selfcheck.FAMILIES if f != family)
    assert selfcheck.kernel_ok(other, "cpu") is True


def test_the_cpu_paths_ask_for_no_certificate(monkeypatch):
    def never(family, device=None):
        raise AssertionError("kernel_ok called for %s" % (device,))

    monkeypatch.setattr(selfcheck, "kernel_ok", never)
    x = np.arange(40, dtype=np.int64).reshape(4, 10)
    be = BlockEncoder("cpu")
    enc = be.encode_int_blocks(x)
    np.testing.assert_array_equal(
        be.decode_int_blocks(enc.payloads, enc.mins, enc.bits, 10), x)
    f = be.encode_float_blocks(x.astype(np.float32), 0.0, 250.0, 250000)
    be.decode_float_blocks(f.payloads, f.mins, f.bits, 0.0, 250.0, 250000,
                           10, dither="uniform")


def _spy_on_wrappers(monkeypatch):
    """Record every call of an encode or decode entry the paths use."""
    calls = []
    for mod, name in ((encode, "start_float_group"),
                      (encode, "encode_int_group"),
                      (encode, "start_int_group"),
                      (decode, "decode_float_group"),
                      (decode, "decode_int_group")):
        fn = getattr(mod, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    return calls


def test_a_divergence_stops_the_encoder_and_the_readers(monkeypatch):
    """With the CPU treated as a device to certify, a diverging family
    raises out of ``BlockEncoder`` and ``device_common`` before any work
    is queued: no payload and no value comes from another route."""
    monkeypatch.setattr(selfcheck, "_CERTIFIED_TYPES", ("cuda", "cpu"))
    x = np.arange(40, dtype=np.int64).reshape(4, 10)
    be = BlockEncoder(["cpu", "cpu"])
    good = be.encode_int_blocks(x)
    selfcheck.reset()

    monkeypatch.setattr(encode, "delta_pack_int_plain",
                        _flip_first_word(encode.delta_pack_int_plain))
    monkeypatch.setattr(decode, "decode_int_plain",
                        _flip_first_word(decode.decode_int_plain))
    calls = _spy_on_wrappers(monkeypatch)
    with pytest.raises(selfcheck.SelfCheckError, match="'encode'"):
        be.encode_int_blocks(x)
    with pytest.raises(selfcheck.SelfCheckError, match="'encode'"):
        be.encode_float_blocks(x.astype(np.float32), 0.0, 250.0, 250000)
    with pytest.raises(selfcheck.SelfCheckError, match="'decode'"):
        be.decode_int_blocks(good.payloads, good.mins, good.bits, 10)
    words = np.zeros((1, 6), np.uint32)
    with pytest.raises(selfcheck.SelfCheckError, match="'decode'"):
        device_common.group_decode(words, [0], [0.0], [250.0], [250000],
                                   [True], 18, 10, "none", [0], 0, "cpu")
    # only the checks themselves reached a wrapper, each family once
    assert calls.count("start_float_group") == 1   # the encode check's K1
    assert calls.count("encode_int_group") == 1    # stopped at 41 bits
    assert calls.count("start_int_group") == 1     # the check's, no other
    assert calls.count("decode_float_group") == 1  # stopped at none
    assert calls.count("decode_int_group") == 0


def test_concurrent_first_uses_run_one_check(monkeypatch):
    """Eight threads (text_to_minh --device --jobs=N) meet an empty
    cache: the lock lets one run the check, the others read its verdict."""
    runs = []
    real = selfcheck._CHECKS["encode"]
    gate = threading.Barrier(8)

    def slow(dev):
        runs.append(dev)
        real(dev)

    monkeypatch.setitem(selfcheck._CHECKS, "encode", slow)
    results = []

    def use():
        gate.wait(timeout=30)
        results.append(selfcheck.kernel_ok("encode", "cpu"))

    threads = [threading.Thread(target=use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert results == [True] * 8 and len(runs) == 1
