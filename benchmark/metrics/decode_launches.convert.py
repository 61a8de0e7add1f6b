"""``decode_launches`` of the conversions that read their input on the card,
which move ``convert_rate``: the reading of ``metrics/decode_launches.py``."""

from pathlib import Path

from harness.cell import reader

read = reader("decode_launches", Path(__file__).resolve().parents[1])
