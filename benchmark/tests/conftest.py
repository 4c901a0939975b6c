import pytest


@pytest.fixture
def card():
    """Skips a card test where there is no card; decided here, never at
    import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
