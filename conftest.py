"""Root conftest: make the src/ layout importable from a clean checkout.

``python -m pytest`` then works without exporting PYTHONPATH (the tier-1
command keeps setting it explicitly; both paths resolve to the same tree).
"""
import os
import sys

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one (run on the card: "
        "python3 -m pytest -q -m card tests/)")
