"""File formats on the device.

``minh_device`` and ``minp_device`` hold the port's device reads.  The
formats themselves (writers, readers, column specs) are the reference
package's host modules ``minnow_tpu.formats.minh`` and ``.minp``, which
touch no device and import no jax; callers import them from there.
"""
