"""``read_copy_ms`` of the conversions that read their input on the card,
which move ``convert_rate``: the reading of ``metrics/read_copy_ms.py``."""

from pathlib import Path

from harness.cell import reader

read = reader("read_copy_ms", Path(__file__).resolve().parents[1])
