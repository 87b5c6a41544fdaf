"""Numpy oracles and host keygen helpers (no framework)."""
