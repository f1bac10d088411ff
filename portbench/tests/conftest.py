"""Tests of the benchmark itself, on the CPU at small sizes; those marked
`cuda` need a card and skip without one (the card is looked for inside a
fixture, never while a module is imported)."""

import copy

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"


@pytest.fixture
def tiny_qp():
    """The dense_qp configuration at a size the CPU solves in a second."""
    from portbench import registry

    cfg = copy.deepcopy(registry.config(registry.benchmark(), "dense_qp"))
    cfg.update(m=30, n=20, cone={"l": 30})
    return cfg


@pytest.fixture
def tiny_traffic():
    return {"batch": 4, "pool": 2, "base_seed": 3, "warmup_iters": 10}
