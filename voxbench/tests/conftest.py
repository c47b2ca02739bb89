"""The benchmark's tests: the repository's root on the path, and the
repository's ``cuda`` marker (tests that need the card decide inside the
test, and skip here)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the PyTorch port's CUDA kernels); "
        "skipped where torch.cuda.is_available() is false",
    )
