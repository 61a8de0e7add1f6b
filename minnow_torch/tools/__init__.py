"""Measurement scripts for the port's kernels on a CUDA card."""
