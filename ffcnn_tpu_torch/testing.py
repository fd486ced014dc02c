"""What the port's CPU tests share and no entry point uses: each
``tests/test_torch_*.py`` calls ``cap_threads`` when it is imported."""

from __future__ import annotations

import os

import torch


def cap_threads() -> int:
    """Give torch's intra-op pool of a pytest-xdist worker its share of the
    cores, max(1, cores // workers), the workers read from
    ``PYTEST_XDIST_WORKER_COUNT``; outside xdist torch keeps its default.
    Every worker would otherwise start a pool as wide as the machine, and
    a few such workers together oversubscribe its cores many times over.
    A worker imports every test module when it collects, so a call at
    import takes effect before any test runs.  Returns the pool's
    size."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
    if workers < 1:
        return torch.get_num_threads()
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:      # no affinity call on this platform
        cores = os.cpu_count() or 1
    k = max(1, cores // workers)
    if torch.get_num_threads() != k:
        torch.set_num_threads(k)
    return k
