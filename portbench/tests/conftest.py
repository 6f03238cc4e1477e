"""Registers the `card` marker: tests that need an NVIDIA card; each
decides inside the test whether there is one and skips with the reason."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skipped without one")
