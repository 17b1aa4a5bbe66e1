"""One CPU thread budget for each pytest-xdist worker.

Under xdist every worker would keep torch's default intra-op pool, one
thread a core, so N workers put N threads on each core and a test that
takes seconds alone takes minutes beside the others.  Each worker gets
its share of the cores instead: max(1, cpu_count // worker count) threads,
set in the environment before torch is imported, so that the processes a
test starts (the data feed's spawned workers, the CLI and web
subprocesses) run under the same budget.  Outside xdist nothing changes.

A test must not set torch's thread count itself: the setting outlives the
test and reaches every file that runs after it on the same worker
(tests/test_torch_thread_budget.py checks the budget is still in place).
This file loads ahead of tests/conftest.py and imports no JAX.
"""

import os

_workers = os.environ.get('PYTEST_XDIST_WORKER_COUNT')
if _workers:
    _threads = str(max(1, (os.cpu_count() or 1) // int(_workers)))
    os.environ['OMP_NUM_THREADS'] = _threads

    import torch  # noqa: E402

    torch.set_num_threads(int(_threads))
