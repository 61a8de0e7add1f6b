"""Batched block encode and decode on one device or several, and the
multi-process gather to one file."""
