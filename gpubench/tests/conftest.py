"""The benchmark's tests. They run on the CPU; a test that needs the card
carries the ``card`` marker and skips, with a reason, where there is none
(decided inside the test, never while a module is imported)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")
