"""One intra-op thread for the port's CPU tests.

The tier-1 run starts six pytest workers on the machine's cores, and
each worker's torch (OpenMP) and numpy (OpenBLAS) would start a thread
per core: the workers' threads then wait on each other, and a test that
takes 18 s alone took 239 s beside the others. Every port test module
imports ``one_thread``, an autouse fixture of module scope: while the
module's tests run, torch and the BLAS libraries use one thread, and
the processes they start (the ranks, the CLIs) inherit
``OMP_NUM_THREADS=1``. The tests compute the same functions; only the
order of some f32 sums on the CPU changes, within every tolerance.
"""
import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # the card's machine: its tests run alone
        limits = None
    else:
        limits = threadpool_limits(1)
    yield
    if limits is not None:
        limits.restore_original_limits()
    torch.set_num_threads(threads)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env
