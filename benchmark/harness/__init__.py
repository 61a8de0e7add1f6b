"""The benchmark's harness: one run of one cell, its spans, trace and roofline."""
