"""Codec arithmetic, stream packing and the CUDA kernel wrappers."""
