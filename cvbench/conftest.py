"""pytest settings of the benchmark's own tests (`python -m pytest cvbench`):
the repository root on sys.path, and the `card` marker of tests that need
a CUDA device, which skip inside the test where there is none."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")
