"""Torch's intra-op threads on pytest-xdist workers.

Each xdist worker is a process whose torch runs one OpenMP thread per core
by default; six workers on eight cores then run 48 spinning threads, and a
test whose torch work takes 8 s alone took over 300 s beside five busy
siblings. pytest collects every test file in every worker before it runs
any test, so importing this module caps the worker's torch at its share of
the cores (``cores // workers``, at least 1) for the whole run. A run
without xdist keeps torch's default.
"""
import os

import torch


def _xdist_share():
    """This worker's share of the cores, or None outside xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return max(1, (os.cpu_count() or 1) // int(workers))


_SHARE = _xdist_share()
if _SHARE is not None:
    torch.set_num_threads(_SHARE)


def test_xdist_worker_runs_torch_on_its_share_of_the_cores():
    if _SHARE is None:
        assert torch.get_num_threads() >= 1
    else:
        assert torch.get_num_threads() == _SHARE
