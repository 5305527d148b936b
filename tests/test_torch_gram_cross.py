"""The fused Gram kernel's plain version and ``normal_equations``: the
port against ``keystone_tpu``.

Same seeded numpy inputs through both packages. The JAX side runs its
Pallas kernel ``gram_cross_pallas`` in interpret mode, as its own tests
do on the CPU; the port's wrapper takes its plain version for CPU
tensors. Both accumulate in float32 and differ only in summation order,
so the JAX package's own bar holds: rtol = atol = 2e-4
(``tests/test_pallas_kernels.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.ops import linalg as jlinalg
from keystone_tpu.ops.pallas_kernels import gram_cross_pallas
from keystone_tpu_torch.ops import kernels
from keystone_tpu_torch.ops import linalg as tlinalg

TOL = 2e-4


def _xy(n, d, k, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d).astype(np.float32),
            rng.randn(n, k).astype(np.float32))


@pytest.mark.parametrize("n,d,k", [(100, 37, 5), (513, 128, 16), (7, 3, 2)])
def test_gram_cross_plain_matches_pallas_interpret(n, d, k):
    X, Y = _xy(n, d, k)
    jg, jc = gram_cross_pallas(jnp.asarray(X), jnp.asarray(Y),
                               interpret=True)
    before = dict(kernels.LAUNCHES)
    G, C = kernels.gram_cross(torch.as_tensor(X), torch.as_tensor(Y))
    assert kernels.LAUNCHES == before  # CPU tensors never launch
    np.testing.assert_allclose(G.numpy(), np.asarray(jg), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(C.numpy(), np.asarray(jc), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(
        G.numpy(), kernels.gram_cross_plain(torch.as_tensor(X),
                                            torch.as_tensor(Y))[0].numpy())


def test_gram_cross_accumulates_into_a_nonzero_carry_in_place():
    X1, Y1 = _xy(64, 12, 3, seed=1)
    X2, Y2 = _xy(40, 12, 3, seed=2)
    G0 = np.random.RandomState(3).randn(12, 12).astype(np.float32)
    G0 = G0 + G0.T
    C0 = np.random.RandomState(4).randn(12, 3).astype(np.float32)
    G, C = torch.as_tensor(G0.copy()), torch.as_tensor(C0.copy())
    outs = kernels.gram_cross(torch.as_tensor(X1), torch.as_tensor(Y1), G, C)
    assert outs[0] is G and outs[1] is C
    kernels.gram_cross(torch.as_tensor(X2), torch.as_tensor(Y2), G, C)
    X, Y = np.concatenate([X1, X2]), np.concatenate([Y1, Y2])
    np.testing.assert_allclose(G.numpy(), G0 + X.T @ X, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(C.numpy(), C0 + X.T @ Y, rtol=TOL, atol=TOL)


def test_gram_cross_promotes_uint8_instead_of_wrapping():
    rng = np.random.RandomState(5)
    X = rng.randint(0, 256, size=(33, 6), dtype=np.uint8)
    Y = rng.randint(0, 256, size=(33, 2), dtype=np.uint8)
    G, C = kernels.gram_cross(torch.as_tensor(X), torch.as_tensor(Y))
    assert G.dtype == C.dtype == torch.float32
    Xf, Yf = X.astype(np.float64), Y.astype(np.float64)
    # exact: every product and sum is an integer below 2^24
    np.testing.assert_array_equal(G.numpy(), Xf.T @ Xf)
    np.testing.assert_array_equal(C.numpy(), Xf.T @ Yf)
    assert G.numpy().max() > 255 * 255  # would have wrapped mod 256


def test_gram_cross_rejects_a_carry_of_the_wrong_shape():
    X, Y = _xy(8, 4, 2)
    with pytest.raises(ValueError, match="carry"):
        kernels.gram_cross(torch.as_tensor(X), torch.as_tensor(Y),
                           torch.zeros(3, 3), torch.zeros(4, 2))
    with pytest.raises(ValueError, match="not \\(n, d\\)"):
        kernels.gram_cross(torch.as_tensor(X), torch.as_tensor(Y[:5]))


@pytest.mark.parametrize("lam", [0.0, 0.1, 10.0])
def test_normal_equations_matches_reference(lam):
    rng = np.random.RandomState(6)
    A = (rng.randn(200, 16) + rng.rand(16)).astype(np.float32)
    Y = rng.randn(200, 3).astype(np.float32)
    want = np.asarray(jlinalg.normal_equations(jnp.asarray(A),
                                               jnp.asarray(Y), lam))
    got = tlinalg.normal_equations(torch.as_tensor(A), torch.as_tensor(Y),
                                   lam).numpy()
    # a solve amplifies the Gram's rounding by its conditioning (kappa of
    # a few hundred here): the 1e-4 relative bar of the port's solvers
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
