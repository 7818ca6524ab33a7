"""The Triton-route base-case kernel in interpret mode, against NumPy.

The compiled kernel runs on the card in ``tests/test_chip.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bask_tpu.ops.triton_chol_base import chol_inv_base


@pytest.mark.parametrize("B,m", [(50, 32), (7, 24), (1, 32)])
def test_chol_inv_base_matches_numpy(B, m):
    G = np.random.RandomState(B * m).randn(B, m, m)
    A = G @ G.transpose(0, 2, 1) / m + np.eye(m)
    with jax.enable_x64(False):
        L, Li = chol_inv_base(jnp.asarray(A, jnp.float32), interpret=True)
    Lr = np.linalg.cholesky(A)
    assert L.shape == Li.shape == (B, m, m)
    np.testing.assert_allclose(np.asarray(L), Lr, atol=1e-5)
    np.testing.assert_allclose(np.asarray(Li), np.linalg.inv(Lr), atol=1e-5)


def test_non_pd_pivot_propagates_nan():
    """A negative pivot gives NaN from that column on (the branchless
    -inf LML contract); the columns before it stay exact."""
    A = np.eye(32, dtype=np.float32)[None].copy()
    A[0, 5, 5] = -1.0
    with jax.enable_x64(False):
        L, Li = chol_inv_base(jnp.asarray(A), interpret=True)
    L, Li = np.asarray(L)[0], np.asarray(Li)[0]
    assert np.isnan(L[5:, 5]).all() and np.isnan(Li[5]).any()
    np.testing.assert_array_equal(L[:5, :5], np.eye(5))
