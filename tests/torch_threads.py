"""One thread for torch and for the BLAS and OpenMP libraries while a port
test module runs (``from torch_threads import one_thread``; module-scoped
and autouse).

pytest-xdist runs several test files at once on one host, and torch,
OpenBLAS and OpenMP each start a thread per core in every worker: their
spinning threads crowd the workers out. One GW test takes 3.6 s alone and
did not finish in 600 s beside five copies of itself; one band-structure
test 21.8 s alone, and 6 s each as six copies on one thread.
"""
import pytest
import torch
from threadpoolctl import threadpool_limits


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)
