"""One share of the cores for torch's intra-op pool in each pytest-xdist worker.

Under ``pytest -n W`` every worker process would otherwise start a pool of
as many threads as the machine has cores, and W such pools oversubscribe
the cores many times over (on 8 cores with ``-n 6``, two KinFu parity tests
ran 20.7 s alone and had not ended after 200 s as six copies; with one
thread each they took 32-36 s). Each ``tests/test_torch_*.py`` imports this
module before its first torch op. Outside xdist it does nothing.
"""

import os

import torch

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(_WORKERS)))
