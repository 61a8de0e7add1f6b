"""Argument checks and launch shapes shared by the kernel wrappers."""

from __future__ import annotations

import threading

import torch

THREADS = 256  # threads per CTA (csrc/bitstream.cuh kThreads)

# held around each ``K*_LAUNCHES += 1``: host threads that share an encoder
# (``text_to_minh --device --jobs=N``) must not lose a count
COUNT_LOCK = threading.Lock()


def grid_y(work: int, per_thread: int) -> int:
    """CTAs along a block's elements or words so that each thread takes
    about ``per_thread`` of its block's ``work`` items (1..65535)."""
    return max(1, min(65535, -(-int(work) // (THREADS * per_thread))))


def on_card(*tensors) -> bool:
    """True when the tensors lie on a CUDA device (the kernel runs), False
    when they lie on the CPU (the plain version runs).  Tensors on two
    devices, or on any other kind of device, raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("tensors on several devices: %s"
                         % sorted(str(d) for d in devices))
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError("no kernel or plain version for device %s" % dev)


def expect(t, name: str, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and
    ``shape`` (None entries match any size)."""
    if not torch.is_tensor(t):
        raise TypeError("%s must be a tensor, got %s" % (name, type(t)))
    if t.dtype != dtype:
        raise TypeError("%s must be %s, got %s" % (name, dtype, t.dtype))
    if t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError("%s must have shape %s, got %s"
                         % (name, tuple(shape), tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
