"""Command-line converters."""
