import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (the benchmark's own checks at a cell's size)")


@pytest.fixture
def cuda_device():
    """The card, or a skip where none is visible (decided in the test, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the comparison's control is read at the cell's size on the card")
    return torch.device("cuda", 0)
