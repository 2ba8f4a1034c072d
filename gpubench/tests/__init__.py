"""The benchmark's tests (run on the CPU; see conftest.py)."""
