"""pytest settings of the benchmark's own tests (run them with
``python -m pytest benchmark/tests``). Tests that need the card carry the
``card`` marker and decide inside a fixture whether one is present."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips on a host without one")
