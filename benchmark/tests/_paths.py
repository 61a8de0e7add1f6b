"""Puts the checkout and the benchmark's folder on ``sys.path``, as
``benchmark/run.py`` does, for the benchmark's tests."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)
