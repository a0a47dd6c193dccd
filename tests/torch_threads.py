"""The torch CPU threads of a test process: the cores it may run on,
shared among the pytest-xdist workers.

Each worker's torch otherwise starts one thread per core, and the workers'
threads then spin against each other: on 8 cores, four concurrent runs of
``tests/test_torch_export.py`` took 360 s each with torch's default threads
and 68 s each with 2 threads (one run alone: 72 s). Every worker imports
every test module while it collects, so the port's test files import this
module and the share holds in each worker, whichever files it runs.
"""

import os

import torch


def share_cores() -> int:
    """Set and return the thread count: the process's cores over the
    workers (``PYTEST_XDIST_WORKER_COUNT``; one without xdist), at least 1."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    threads = max(1, len(os.sched_getaffinity(0)) // workers)
    torch.set_num_threads(threads)
    return threads


share_cores()
