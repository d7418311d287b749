"""On-card test environment, the counterpart of `tests_tpu/`.

Unlike `tests/` (CPU only, every entry point asked for the CPU), this
suite runs dprast_torch on the CUDA card, where the kernels of
`dprast_torch/csrc/` are built and launched, and skips every test where
there is no card.  Run it with:  python -m pytest tests_gpu/ -q
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs on a CUDA card; skipped where there is none")


@pytest.fixture(autouse=True)
def _needs_a_card():
    # decided per test, not while collecting: every worker collects the
    # same tests
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device present")
