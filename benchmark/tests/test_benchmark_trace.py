"""The reduction of a profiler trace: the window, the device's busy time
as the union of its intervals, kernel times by function name, and idle
gaps named by the host span open at their middle."""

import pytest

import _paths  # noqa: F401  (the benchmark on sys.path)

from harness.trace import Trace, kernel_name


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_busy_gaps_and_kernels():
    events = [
        ev("window", "user_annotation", 1000, 1000),
        ev("read_call", "user_annotation", 1000, 600),
        ev("open", "user_annotation", 1700, 200),
        ev("void (anonymous namespace)::decode_kernel<int>(unsigned int)",
           "kernel", 1100, 100),
        ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1150, 100),
        ev("(anonymous namespace)::decode_kernel(unsigned int const*)",
           "kernel", 1500, 50),
        ev("Memset (Device)", "gpu_memset", 1980, 40),  # past the window
        ev("decode_kernel", "gpu_user_annotation", 1000, 1000),
        ev("elsewhere", "kernel", 5000, 10),
        {"ph": "i", "name": "marker", "ts": 1200},
    ]
    t = Trace(events)
    assert t.window_s == pytest.approx(1e-3)
    # [1100, 1250] + [1500, 1550] + [1980, 2000]
    assert t.busy_s == pytest.approx(220e-6)
    assert t.kernels == {"decode_kernel": pytest.approx(150e-6)}
    assert t.kernel_seconds(("decode_kernel",)) == pytest.approx(150e-6)
    assert [g[0] for g in t.gaps] == ["open", "read_call", "read_call"]
    assert t.gaps[0][1] == pytest.approx(430e-6)
    ops = dict(t.breakdown()["device_ops"])
    assert ops["Memcpy HtoD (Pageable -> Device)"] == pytest.approx(100e-6)


def test_kernel_names():
    assert kernel_name("void at::native::reduce_kernel<512, 1>(x)") == \
        "at::native::reduce_kernel"
    assert kernel_name("(anonymous namespace)::pack_int_kernel(long long "
                       "const*, long long, unsigned int") == "pack_int_kernel"


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(ValueError):
        Trace([ev("read_call", "user_annotation", 0, 10)])
