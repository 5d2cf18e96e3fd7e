"""Utilities: profiling, plotting."""
