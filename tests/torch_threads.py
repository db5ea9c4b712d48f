"""The port's test modules' share of the cores: a module fixture that holds
torch's intra-op threads to the cores over the pytest-xdist workers while
the module runs, and gives the worker its setting back afterwards. At
torch's default every worker's threads take every core and spin on each
other: a tiny UNet evaluation that takes 0.08 s on one thread took 11 s at
8 threads on a busy 8-core host. A module takes it with
`from tests.torch_threads import worker_threads  # noqa: F401`; the card's
tests/test_torch_cuda.py does not, since it runs alone there and imports
nothing from `tests`."""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def worker_threads():
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, min(n, (os.cpu_count() or 1) // workers)))
    yield
    torch.set_num_threads(n)
