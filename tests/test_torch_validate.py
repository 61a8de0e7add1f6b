"""The port's exactness validation (``ops.validate``) on the CPU: every
section passes on the plain versions, reports as the reference's does, a
broken codec makes each section raise, and the port's soak tool draws
pass.  The device quantize and dequantize are also held to the JAX
package's on the reference's own inputs, bitwise."""

import numpy as np
import pytest
import torch

import jax
from minnow_tpu.core import spec
from minnow_tpu.ops import codec as jax_codec
from minnow_torch.ops import bitpack, codec, decode, encode, validate
from minnow_torch.tools import kernel_fuzz_soak

N = 20_000


def test_validate_quantize_passes():
    validate.validate_quantize("cpu", n=N)


def test_validate_dequantize_passes():
    validate.validate_dequantize("cpu", n=N)


def test_validate_pack_passes():
    validate.validate_pack("cpu")


def test_validate_kernels_covers_every_width():
    widths = validate.validate_kernels("cpu", n=515)
    for name in ("K1", "K2", "K5"):
        assert set(range(1, 33)) <= set(widths[name]), name
    for name in ("K3", "K4"):
        assert widths[name] == list(range(65)), name


def test_validate_backend_reports_as_the_reference(monkeypatch):
    for name in ("validate_quantize", "validate_dequantize"):
        fn = getattr(validate, name)
        monkeypatch.setattr(validate, name,
                            lambda dev, _fn=fn: _fn(dev, n=N // 4))
    report = validate.validate_backend("cpu")
    assert report == {"backend": "cpu", "device": "cpu", "exact": True,
                      "K1": True, "K2": True, "K3": True, "K4": True,
                      "K5": True}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        validate.validate_backend()


@pytest.mark.parametrize("low,high,dx", [(0.0, 250.0, 0.001),
                                         (-50.0, 100.0, 1.0),
                                         (0.0, 1.0, 1 / 7), (1.0, 5.0, 1e-4),
                                         (5.0, 16.0, 0.001)])
def test_device_quantize_equals_the_jax_codec(low, high, dx):
    """The reference's configs (``validate.py:40-42``) and its
    one-ulp-around-each-boundary inputs (``:56-62``) through both
    packages' device quantize."""
    rng = np.random.default_rng(0)
    pixels = spec.float_group_pixels(low, high, dx)
    dxq = spec.quantize_dx(low, high, pixels)
    grid = (np.float32(low) + rng.integers(1, pixels, 2000).astype(
        np.float32) * dxq).astype(np.float32)
    x = np.concatenate([rng.uniform(low, high, 5000).astype(np.float32),
                        np.nextafter(grid, np.float32(-np.inf)), grid,
                        np.nextafter(grid, np.float32(np.inf))])
    x = x[(x >= low) & (x < high)]
    got = validate._device_quantize(x, low, high, pixels, "cpu")
    want = np.asarray(jax.jit(jax_codec.quantize)(
        x, np.float32(low), np.float32(high), np.int64(pixels)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, spec.quantize(x, low, high, pixels))


@pytest.mark.parametrize("low,high,dx", [(0.0, 250.0, 0.001),
                                         (-50.0, 100.0, 0.25),
                                         (5.0, 16.0, 0.001)])
def test_device_dequantize_equals_the_jax_codec(low, high, dx):
    """``validate.py:81-85``, the q = 6276 case among them."""
    rng = np.random.default_rng(1)
    pixels = spec.float_group_pixels(low, high, dx)
    q = rng.integers(0, pixels, 5000)
    q[0] = min(6276, pixels - 1)
    params = codec.block_params([low], [high], [pixels], [False], "cpu")
    got = codec.dequantize(torch.from_numpy(q)[None, :], params.low,
                           params.dx)[0].numpy()
    want = np.asarray(jax.jit(
        lambda q, lo, hi, p: jax_codec.dequantize(q, lo, hi, p))(
            q, np.float32(low), np.float32(high), np.int64(pixels)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        got.view(np.int32),
        spec.dequantize(q, low, high, pixels).view(np.int32))


def _off_by_one_quantize(x, low, dx):
    q, ok = _off_by_one_quantize.real(x, low, dx)
    return q + (q == 6276), ok


def _fused_dequantize(q, low, dx, u=None):
    v = q.to(torch.float64) + (0.0 if u is None else u)
    # one rounding in place of two: what an FMA contraction would do
    return (dx[:, None].to(torch.float64) * v.to(torch.float32).to(
        torch.float64) + low[:, None].to(torch.float64)).to(torch.float32)


def _shifted_pack(values, bits, lens, offsets, total):
    return _shifted_pack.real(values ^ 2, bits, lens, offsets, total)


def _shifted_hash(c, k1, k2):
    return _shifted_hash.real(c + 1, k1, k2)


def _low_minimum(x, lens):
    stats = _low_minimum.real(x, lens).clone()
    stats[:, 0] -= 1
    return stats


def _wider_plan(stats, lens):
    plan = _wider_plan.real(stats, lens).clone()
    b = len(lens)
    plan[2 * b:3 * b] = torch.clamp(plan[2 * b:3 * b] + 1, max=64)
    return plan


# (module, attribute, replacement, the section that must raise, its words)
BREAKS = [
    (codec, "quantize", _off_by_one_quantize, "validate_quantize",
     "quantize diverges"),
    (codec, "dequantize", _fused_dequantize, "validate_dequantize",
     "dequantize diverges"),
    (bitpack, "pack", _shifted_pack, "validate_pack", "pack diverges"),
    (bitpack, "pack", _shifted_pack, "validate_kernels",
     "payload diverges"),
    (codec, "dither_hash_u", _shifted_hash, "validate_kernels",
     "K2 uniform decode diverges"),
    # K3's stats and plan launches, which the int encode runs
    (encode, "int_stats_plain", _low_minimum, "validate_kernels",
     "K3 plan diverges"),
    (encode, "int_plan_plain", _wider_plan, "validate_kernels",
     "K3 plan diverges"),
]


@pytest.mark.parametrize("mod,name,broken,section,words", BREAKS)
def test_a_divergence_raises(mod, name, broken, section, words, monkeypatch):
    broken.real = getattr(mod, name)
    monkeypatch.setattr(mod, name, broken)
    with pytest.raises(AssertionError, match=words):
        getattr(validate, section)("cpu")


def test_validate_backend_raises_and_reroutes_nothing(monkeypatch):
    _shifted_pack.real = bitpack.pack
    monkeypatch.setattr(bitpack, "pack", _shifted_pack)
    monkeypatch.setattr(validate, "validate_quantize", lambda dev: None)
    monkeypatch.setattr(validate, "validate_dequantize", lambda dev: None)
    with pytest.raises(AssertionError, match="pack diverges"):
        validate.validate_backend("cpu")


@pytest.mark.parametrize("case", kernel_fuzz_soak.CASES,
                         ids=lambda c: c.__name__)
@pytest.mark.parametrize("seed", range(6))
def test_soak_draws_pass_on_the_cpu(case, seed):
    case(np.random.default_rng(31337 + seed), torch.device("cpu"))


@pytest.mark.parametrize("bits", [1, 18, 33, 64])
def test_soak_sweep_shapes_pass_on_the_cpu(bits):
    """The fixed shapes of the every-width sweep, on the plain versions."""
    dev = torch.device("cpu")
    rng = np.random.default_rng(bits)
    kernel_fuzz_soak.one_int_pack(rng, dev, bits=bits)
    if 2 <= bits <= 24:
        kernel_fuzz_soak.one_uniform(rng, dev, bits=bits)
        kernel_fuzz_soak.one_float_encode(rng, dev, bits=bits)


def test_soak_main_reports_and_fails_on_a_divergence(monkeypatch, capsys):
    assert kernel_fuzz_soak.main(["10", "--reps=1", "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "on the CPU, the kernels' plain versions" in out
    assert "SOAK OK: 10 seeds" in out
    assert "SWEEP OK: 64 widths int, 23 widths float, 1 reps" in out
    # with no flag it runs on the card, and raises without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["3"], ["--device=cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            kernel_fuzz_soak.main(argv)
    with pytest.raises(SystemExit):
        kernel_fuzz_soak.main(["--device"])
    monkeypatch.setattr(decode, "decode_int_plain",
                        lambda *a: torch.zeros((1, a[3]), dtype=torch.int64))
    with pytest.raises(AssertionError, match="int_unpack"):
        kernel_fuzz_soak.main(["3", "--device=cpu"])
