"""The thread budget of the repo-root conftest.py: in a pytest-xdist
worker, torch's intra-op threads are the worker's share of the cores when
this test runs, in this process and in a process it starts, so a test
that set its own count and leaked it into later files on its worker fails
here; outside xdist torch's default stands."""

import os
import subprocess
import sys

import torch


def test_torch_threads_are_the_workers_share_of_the_cores():
    child = subprocess.run(
        [sys.executable, '-c', 'import torch; print(torch.get_num_threads())'],
        capture_output=True, text=True, check=True)
    workers = os.environ.get('PYTEST_XDIST_WORKER_COUNT')
    if workers:
        want = max(1, os.cpu_count() // int(workers))
        assert int(child.stdout) == want
    else:
        want = int(child.stdout)
    assert torch.get_num_threads() == want
