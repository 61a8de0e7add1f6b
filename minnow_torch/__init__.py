"""minnow-torch: the minnow codec on PyTorch and hand-written CUDA kernels.

The PyTorch port of ``minnow_tpu``.  It writes and reads the same minnow
container, minh halo-catalog and minp particle-snapshot files, byte for
byte, with the device work done by CUDA kernels for Hopper
(``minnow_torch/csrc``) instead of Pallas kernels for the TPU.

Module names mirror ``minnow_tpu`` so each counterpart is easy to find:

* ``core`` -- the minnow container and the normative numpy codec
  (``core.spec``); ``native`` binds the C++ host engine
  (``native/fastbits.cpp``);
* ``formats.minh`` / ``formats.boundary`` / ``formats.minp`` -- the file
  formats on the host; ``ingest`` -- text catalogs, LGadget-2 snapshots
  and the Lagrangian Grid; ``utils`` -- config files, name index, stage
  timing;
* ``ops.bitpack`` / ``ops.codec`` -- plain PyTorch stream packing and codec
  arithmetic (the semantics of ``core/spec.py``);
* ``ops.encode`` / ``ops.decode`` -- the kernel wrappers, each beside its
  plain PyTorch version;
* ``ops.selfcheck`` -- the one-shot certification of a kernel family at
  its first CUDA use in a process; ``ops.validate`` -- the every-width
  exactness checks of a device (``validate_backend``);
* ``parallel.pipeline.BlockEncoder`` -- batched block encode and decode on
  one device or several (``parallel.mesh``: the devices and the split of
  the block axis);
* ``parallel.distributed`` -- the multi-process writer: ``gather_blocks``
  of every process's encoded blocks to one file, on ``torch.distributed``;
* ``formats.minh_device`` -- bulk column reads of minh files;
* ``formats.minp_device.read_vectors`` -- bulk reads of minp files;
* ``formats.boundary_device`` -- batched boundary-file writes;
* ``cli.text_to_minh``, ``cli.minh_to_bnd``, ``cli.inspect_minh``,
  ``cli.convert_snapshot`` -- the converters, host mode and ``--device``;
  ``cli.print_all_names``, ``cli.verify_minnow`` -- host-only audits;
* ``utils.sched`` -- host task pools (``text_to_minh --jobs``);
* ``tools`` -- scripts for the card: ``multiprocess_gather_check`` (N
  processes, one file, sharded read-back), ``kernel_fuzz_soak``,
  ``time_encode``, ``ab_launch``.

The package stands alone: it imports nothing of ``minnow_tpu`` and no
jax.  Its host layers are its own copies of the reference's, the same
arithmetic and the same bytes on numpy, and each package reads the
other's files.  Importing the package does no device work: kernels are
built with nvcc on first use (``ops._build``).
"""

__version__ = "0.1.0"
