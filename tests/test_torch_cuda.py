"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor ``repro`` (the machine with the card may have
neither), so it also runs without ``tests/conftest.py``:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_cuda.py

Tolerance is zero: every output is a bool mask or an integer.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.domination import domination_cuda
from repro_torch.kernels.gf2_reduce import gf2_reduce_cuda
from repro_torch.kernels.kcore_peel import kcore_peel_cuda

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _graphs(b, n, p, seed, device):
    rng = np.random.default_rng(seed)
    adj = np.triu(rng.random((b, n, n)) < p, 1)
    adj = adj | adj.transpose(0, 2, 1)
    mask = rng.random((b, n)) < 0.9
    mask[0] = False  # an empty graph
    adj &= mask[:, None, :] & mask[:, :, None]
    return (torch.from_numpy(adj).to(device),
            torch.from_numpy(mask).to(device))


def _plain_fixpoint(adj, alive, k):
    while True:
        nxt = ref.kcore_peel_ref(adj, alive, k)
        if torch.equal(nxt, alive):
            return nxt
        alive = nxt


@pytest.mark.parametrize("n,p", [(1, 0.5), (31, 0.2), (64, 0.1), (100, 0.05),
                                 (1000, 0.006), (2048, 0.003)])
def test_kcore_peel_kernel(cuda, n, p):
    adj, mask = _graphs(3, n, p, seed=n, device=cuda)
    for k in (1, 2, 3):
        assert torch.equal(kcore_peel_cuda(adj, mask, k, 1),
                           ref.kcore_peel_ref(adj, mask, k))
        assert torch.equal(kcore_peel_cuda(adj, mask, k, 0),
                           _plain_fixpoint(adj, mask, k))


@pytest.mark.parametrize("n,p", [(1, 0.5), (33, 0.3), (64, 0.1), (257, 0.02),
                                 (1024, 0.005)])
def test_domination_kernel(cuda, n, p):
    adj, mask = _graphs(3, n, p, seed=n, device=cuda)
    assert torch.equal(domination_cuda(adj, mask), ref.domination_ref(adj, mask))


def _blocks(g, s, r, seed, device):
    """Sparse random columns; a third carry a row 31 mod 32 (the sign bit)."""
    rng = np.random.default_rng(seed)
    w = (r + 31) // 32
    dense = np.zeros((g, s, w * 32), bool)
    np.put_along_axis(dense, rng.integers(0, r, size=(g, s, 3)), True, axis=-1)
    hi = 31 + 32 * rng.integers(0, r // 32, size=(g, s))  # rows stay < r
    dense[:, ::3] |= np.eye(w * 32, dtype=bool)[hi[:, ::3]]
    words = (dense.reshape(g, s, w, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    return torch.from_numpy(words.view(np.int32)).to(device)


def test_gf2_kernel_single_launch_of_several_blocks(cuda):
    blocks = [_blocks(3, 80, 96, seed=1, device=cuda),
              _blocks(3, 200, 80, seed=2, device=cuda),
              _blocks(3, 5, 40, seed=3, device=cuda)]
    rows = [96, 80, 40]
    for got, b, r in zip(gf2_reduce_cuda(blocks, rows), blocks, rows):
        for x, y in zip(got, ref.gf2_reduce_ref(b, r)):
            assert torch.equal(x, y)


def test_gf2_kernel_block_past_shared_memory(cuda):
    b = _blocks(2, 1024, 2048, seed=4, device=cuda)  # 256 KiB per matrix
    for x, y in zip(gf2_reduce_cuda([b], [2048])[0],
                    ref.gf2_reduce_ref(b, 2048)):
        assert torch.equal(x, y)


def test_wrappers_launch_and_count(cuda):
    from repro_torch import counters

    adj, mask = _graphs(2, 40, 0.2, seed=5, device=cuda)
    counters.reset()
    ops.kcore_peel(adj, mask, 2, sweeps=0)
    ops.domination(adj, mask)
    ops.gf2_reduce(_blocks(1, 10, 32, seed=6, device=cuda)[0], 32)
    snap = counters.snapshot()
    assert (snap["kcore_peel"], snap["domination"], snap["gf2_reduce"]) == (1, 1, 1)
