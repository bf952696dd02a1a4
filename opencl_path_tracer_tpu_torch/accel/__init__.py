"""Acceleration-structure helpers (only the Morton codes so far)."""
