"""The CUDA kernels of pcl_tpu_torch against their plain PyTorch versions.

These tests need a CUDA device and skip without one (the kernels have no CPU
mode). They import neither JAX nor pcl_tpu, so they run on a GPU machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pcl_tpu_torch.core.cloud import make_cloud
from pcl_tpu_torch.ops import nn1 as nn1_mod
from pcl_tpu_torch.registration import icp as icp_mod


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(seed, nq, m, valid_frac, dup=False):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-50, 50, size=(m, 3)).astype(np.float32)
    if dup:
        t[m // 2:] = t[: m - m // 2].copy()
    q = rng.uniform(-50, 50, size=(nq, 3)).astype(np.float32)
    if dup:
        q[: nq // 2] = t[rng.integers(0, m, nq // 2)]
    tm = rng.uniform(size=m) < valid_frac
    return t, tm, q


@pytest.mark.parametrize("nq,m,valid_frac,dup", [
    (1000, 3001, 0.9, False),      # ragged, masked
    (77, 500, 0.0, False),         # no valid target
    (513, 4097, 1.0, True),        # exact ties
    (5, 0, 1.0, False),            # empty target
    (20000, 30000, 1.0, False),
])
def test_nn1_kernel_matches_plain(cuda, nq, m, valid_frac, dup):
    t, tm, q = (torch.from_numpy(a).to(cuda) for a in _inputs(0, nq, m, valid_frac, dup))
    before = nn1_mod.nn1.launches
    ik, dk = nn1_mod.nn1(t, tm, q)
    ip, dp = nn1_mod.nn1_plain(t, tm, q)
    torch.cuda.synchronize()
    assert nn1_mod.nn1.launches == before + 1
    # the plain version repeats the kernel's float32 arithmetic: equal
    assert torch.equal(ik, ip)
    assert torch.equal(dk, dp)


def test_nn1_kernel_rejects(cuda):
    t = torch.zeros((10, 3), device=cuda)
    tm = torch.ones(10, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="3-D"):
        nn1_mod.nn1(torch.zeros((10, 6), device=cuda), tm, torch.zeros((4, 6), device=cuda))
    with pytest.raises(TypeError):
        nn1_mod.nn1(t.double(), tm, t.double())
    with pytest.raises(ValueError, match="contiguous"):
        nn1_mod.nn1(t.t().contiguous().t(), tm, t)
    with pytest.raises(ValueError, match="different devices"):
        nn1_mod.nn1(t, tm.cpu(), t)


def test_icp_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(3)
    tgt = rng.uniform(-1, 1, size=(2048, 3)).astype(np.float32)
    a = 0.1
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
    src = (tgt @ R.T + np.float32([0.05, -0.03, 0.02])).astype(np.float32)
    on_card = icp_mod.icp(make_cloud(src), make_cloud(tgt), max_iterations=30)
    on_cpu = icp_mod.icp(make_cloud(src, device="cpu"), make_cloud(tgt, device="cpu"),
                         max_iterations=30)
    assert int(on_card.iterations) == int(on_cpu.iterations)
    assert int(on_card.convergence_state) == int(on_cpu.convergence_state)
    # float32 reductions in another order: transforms within 1e-5
    np.testing.assert_allclose(on_card.transform.cpu().numpy(), on_cpu.transform.numpy(),
                               atol=1e-5)
