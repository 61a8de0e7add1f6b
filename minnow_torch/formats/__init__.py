"""Concrete file formats on top of the minnow container (counterpart of
``minnow_tpu/formats``).

``minh``, ``boundary`` and ``minp`` are the host formats, on numpy.
``minh_device``, ``minp_device`` and ``boundary_device`` (the
device-batched reads and writes) are not imported here: they pull in
torch, and host-side file IO needs none of it.  Import them explicitly.
"""

from . import boundary, minh, minp
