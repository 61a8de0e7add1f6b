"""minnow-torch: the minnow codec on PyTorch and hand-written CUDA kernels.

The PyTorch port of ``minnow_tpu``.  It writes and reads the same minnow
container, minh halo-catalog and minp particle-snapshot files, byte for
byte, with the device work done by CUDA kernels for Hopper
(``minnow_torch/csrc``) instead of Pallas kernels for the TPU.

Module names mirror ``minnow_tpu`` so each counterpart is easy to find:

* ``ops.bitpack`` / ``ops.codec`` -- plain PyTorch stream packing and codec
  arithmetic (the reference semantics of ``minnow_tpu/core/spec.py``);
* ``ops.encode`` / ``ops.decode`` -- the kernel wrappers, each beside its
  plain PyTorch version;
* ``parallel.pipeline.BlockEncoder`` -- batched block encode on one device;
* ``formats.minh_device`` -- bulk column reads of minh files;
* ``formats.minp_device.read_vectors`` -- bulk reads of minp files;
* ``cli.text_to_minh``, ``cli.minh_to_bnd``, ``cli.inspect_minh``,
  ``cli.convert_snapshot`` -- the converters with ``--device``.

The host layers that touch no device (the container, the minh and minp
formats, text and snapshot ingest, config and name-index parsing) are
the reference package's own jax-free modules and are imported, not
copied.  Nothing here imports jax.  Importing the package does no device
work: kernels are built with nvcc on first use (``ops._build``).
"""

__version__ = "0.1.0"
