"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one (the CUDA kernels
have no CPU mode). They import neither JAX nor the JAX package, so they
also run on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Both sides compute in float32 and differ in summation order; pooled
features reach ~1e4, so the bar is rtol 1e-5 with atol 1e-5 of the
largest feature.
"""
import numpy as np
import pytest
import torch

from keystone_tpu_torch.nodes.images.core import FusedConvRectifyPool
from keystone_tpu_torch.ops import kernels

RTOL, ATOL_REL = 1e-5, 1e-5


def _inputs(B, K, seed):
    rng = np.random.RandomState(seed)
    imgs = (rng.rand(B, 32, 32, 3) * 255).astype(np.float32)
    filters = rng.randn(K, 108).astype(np.float32)
    means = rng.randn(108).astype(np.float32)
    return imgs, filters, means


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("B,K", [(7, 100), (2, 1024), (1, 64)])
def test_cuda_kernel_matches_plain(cuda, B, K):
    imgs, filters, means = (torch.as_tensor(a, device=cuda)
                            for a in _inputs(B, K, seed=B + K))
    before = kernels.LAUNCHES["fused_cifar_featurize"]
    got = kernels.fused_cifar_featurize(imgs, filters, whitener_means=means)
    want = kernels.fused_cifar_featurize_plain(imgs, filters,
                                               whitener_means=means)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_cifar_featurize"] == before + 1
    _close(got.cpu().numpy(), want.cpu().numpy())


def test_cuda_datum_path_launches_the_kernel(cuda):
    imgs, filters, _ = _inputs(2, 32, seed=6)
    node = FusedConvRectifyPool(filters, 32, 6)
    before = kernels.LAUNCHES["fused_cifar_featurize"]
    one = node.apply(torch.as_tensor(imgs[1], device=cuda))
    assert kernels.LAUNCHES["fused_cifar_featurize"] == before + 1
    want = node.apply(torch.as_tensor(imgs[1]))
    _close(one.cpu().numpy(), want.numpy())


def test_cuda_rejects_shapes_the_kernel_does_not_take(cuda):
    imgs, filters, _ = _inputs(1, 8, seed=7)
    with pytest.raises(ValueError):
        kernels.fused_cifar_featurize(
            torch.as_tensor(imgs[:, :31], device=cuda),
            torch.as_tensor(filters, device=cuda))
    with pytest.raises(ValueError):
        kernels.fused_cifar_featurize(
            torch.as_tensor(imgs, device=cuda).double(),
            torch.as_tensor(filters, device=cuda))
