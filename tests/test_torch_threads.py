"""The port's tests under pytest-xdist: the workers share the machine's cores.

Every xdist worker imports every test module when it collects, so this
module's import sets the thread count of torch's CPU ops in each worker.
Left alone, each of the workers starts one OpenMP thread per core, and the
idle threads spin while the other workers hold the cores: a port test that
takes 23 s alone with one thread (the FD test through the "bvh" tables)
took 868 s with the default in a six-worker run of the whole suite on an
eight-core CPU.
Outside xdist nothing changes.
"""

import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))


def test_xdist_workers_share_the_cores():
    if _WORKERS > 1:
        assert torch.get_num_threads() == max(1, (os.cpu_count() or 1)
                                              // _WORKERS)
    else:
        assert torch.get_num_threads() >= 1
