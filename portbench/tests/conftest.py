"""The benchmark's own tests: ``python -m pytest portbench/tests -q``.  Tests
that need the card carry the ``card`` marker and decide inside themselves,
never while this directory is collected, whether a card is there."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
os.environ.setdefault("UEGAN_TORCH_DEVICE", "cpu")


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
