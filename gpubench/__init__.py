"""The port's benchmark (see harness/core.py)."""
