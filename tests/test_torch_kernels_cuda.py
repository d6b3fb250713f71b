"""The CUDA kernels against their plain PyTorch versions, on the card.

Every case carries the ``cuda`` marker and skips on a machine without a
CUDA card (decided in a fixture when the test runs).  This file imports
neither JAX nor the JAX package, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Comparisons are exact, with zero tolerance: the min-plus product is
integer and the frontier expansion boolean.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.graph import INF
from repro_torch.core.packing import pack_bits
from repro_torch.kernels import LAUNCHES, ops, ref

MINPLUS_SHAPES = [(1, 1, 1), (8, 20, 20), (32, 20, 20), (128, 128, 128),
                  (130, 20, 50), (256, 64, 129), (5, 200, 7), (4, 4, 4)]


@pytest.fixture
def cuda_device():
    """The card, decided when a test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels compile and run only there")
    return torch.device("cuda")


def _rand_dist(rng, shape, dev):
    x = rng.integers(0, 64, size=shape)
    x = np.where(rng.random(shape) < 0.2, INF, x).astype(np.int32)
    return torch.from_numpy(x).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MINPLUS_SHAPES)
def test_minplus_kernel_matches_plain(cuda_device, m, k, n):
    rng = np.random.default_rng(m + k + n)
    a, b = _rand_dist(rng, (m, k), cuda_device), _rand_dist(rng, (k, n), cuda_device)
    count = LAUNCHES["minplus"]
    got = ops.minplus(a, b)
    assert LAUNCHES["minplus"] == count + 1
    assert torch.equal(got, ref.minplus_ref(a, b))


@pytest.mark.cuda
def test_minplus_kernel_saturates_and_refuses(cuda_device):
    a = torch.full((4, 4), INF, dtype=torch.int32, device=cuda_device)
    assert bool((ops.minplus(a, a) >= 2 * INF).all())
    with pytest.raises(ValueError, match="widen"):
        ops.minplus(a.to(torch.uint8), a)
    with pytest.raises(ValueError, match="contiguous"):
        ops.minplus(a.T, a)


@pytest.mark.cuda
@pytest.mark.parametrize("k,v,w", [(40, 128, 128), (32, 128, 128), (64, 128, 128),
                                   (40, 128, 100), (17, 70, 90), (5, 3000, 40),
                                   (300, 16, 16)])
def test_bitmap_expand_packed_kernel_matches_plain(cuda_device, k, v, w):
    rng = np.random.default_rng(k + v + w)
    f = torch.from_numpy(rng.random((k, v)) < 0.3).to(cuda_device)
    words = pack_bits(torch.from_numpy(rng.random((v, w)) < 0.1)).to(cuda_device)
    count = LAUNCHES["bitmap_expand_packed"]
    got = ops.bitmap_expand_packed(f, words, n_cols=w)
    assert LAUNCHES["bitmap_expand_packed"] == count + 1
    assert torch.equal(got, ref.bitmap_expand_packed_ref(f, words, w))
