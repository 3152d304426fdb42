"""Imported by the port's test files before they run anything: under
pytest-xdist (which sets ``PYTEST_XDIST_WORKER_COUNT`` in its workers) each
worker caps torch's intra-op threads at its share of the cores, so that the
workers' thread pools do not oversubscribe the machine; a file run alone
keeps torch's default."""

import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))
