"""``read_file_ms`` of the conversions that read their input on the card,
which move ``convert_rate``: the reading of ``metrics/read_file_ms.py``."""

from pathlib import Path

from harness.cell import reader

read = reader("read_file_ms", Path(__file__).resolve().parents[1])
