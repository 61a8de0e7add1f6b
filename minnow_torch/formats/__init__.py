"""File formats on the device.

``minh_device`` holds the port's device reads.  The minh format itself
(writer, reader, column specs) is the reference package's host module
``minnow_tpu.formats.minh``, which touches no device and imports no jax;
callers import it from there.
"""
