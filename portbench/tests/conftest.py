"""The card fixture of the benchmark's tests: a test marked ``cuda`` asks
for ``card``, which skips where there is no CUDA device (decided when the
test runs, never at import)."""

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels)")
    return torch.device("cuda")
