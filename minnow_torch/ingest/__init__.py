"""Text catalog and particle snapshot ingest on the host (counterpart of
``minnow_tpu/ingest``)."""

from . import lgadget2, rockstar, snapshot, text
