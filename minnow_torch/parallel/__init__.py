"""Batched block encode on one device."""
