"""Fixtures of the benchmark's own tests. The tests marked ``card`` need
an NVIDIA card and skip without one: the ``card`` fixture decides, never
an import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (runs the cells at size)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cells run at size only there")
    return torch.cuda.get_device_name(0)
