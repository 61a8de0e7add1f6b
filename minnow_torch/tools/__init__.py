"""Measurement and check scripts for the port's kernels on a CUDA card."""
