"""One intra-op thread for the port's CPU tests.

pytest-xdist runs the suite in several worker processes, and each
PyTorch process starts as many OpenMP threads as the machine has cores:
the workers' threads then spin against each other, and the port's CPU
tests (small tensors through the plain versions) ran up to ten times
slower than alone. Every tests/test_torch_*.py module imports the
autouse fixture below, which runs its tests on one thread and restores
the count after them. No result depends on it: the port's CPU paths
are integer arithmetic, or float32 that is exact on integers.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_port_cpu_tests_run_on_one_thread():
    assert torch.get_num_threads() == 1
