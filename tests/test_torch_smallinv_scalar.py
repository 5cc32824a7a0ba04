"""The port's scalarized small-block inverses and the 3x3 solve and
Cholesky against the JAX package on identical numpy inputs.

Tolerances: float64 rtol 1e-10 / atol 1e-12 (the 6x6 Schur inverse's
nested 3x3 inverses lose ~2 digits); float32 rtol 1e-4 / atol 1e-6 (the
sums of the component products run in another order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pypose_tpu.ops import smallinv as jinv
from pypose_tpu_torch.ops import smallinv as tinv

DTYPES = [np.float32, np.float64]


def tol(dtype):
    return dict(rtol=1e-4, atol=1e-6) if dtype == np.float32 \
        else dict(rtol=1e-10, atol=1e-12)


def spd_blocks(rng, n, d):
    A = rng.normal(size=(n, d, d))
    return A @ np.swapaxes(A, -1, -2) + d * np.eye(d)


def components(M):
    """Row-major component list of [n, d, d] blocks: d*d arrays [n]."""
    d = M.shape[-1]
    return [M[:, i, j] for i in range(d) for j in range(d)]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('d', [3, 6])
def test_blockinv_scalar_matches_jax(d, dtype):
    """blockinv_scalar (and through it inv3x3_scalar / inv6x6_scalar):
    against JAX, and M M^-1 = I."""
    M = spd_blocks(np.random.default_rng(d), 50, d).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        inv_j = np.stack([np.asarray(c) for c in jinv.blockinv_scalar(
            [jnp.asarray(c) for c in components(M)])])
    inv_t = torch.stack(tinv.blockinv_scalar(
        [torch.from_numpy(c) for c in components(M)])).numpy()
    np.testing.assert_allclose(inv_t, inv_j, **tol(dtype))
    inv = inv_t.reshape(d, d, -1).transpose(2, 0, 1).astype(np.float64)
    np.testing.assert_allclose(M @ inv, np.broadcast_to(np.eye(d), M.shape),
                               atol=1e-4 if dtype == np.float32 else 1e-11)
    # the matrix form computes the same inverse
    np.testing.assert_allclose(inv, tinv.blockinv(torch.from_numpy(M)),
                               **tol(dtype))


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name,d', [('inv3x3_scalar', 3),
                                    ('inv6x6_scalar', 6)])
def test_scalar_inverses_match_jax(name, d, dtype):
    """The two closed forms directly, on components of another shape
    ([4, 5] each)."""
    M = spd_blocks(np.random.default_rng(10 + d), 20, d).astype(dtype)
    comps = [c.reshape(4, 5) for c in components(M)]
    with jax.enable_x64(dtype == np.float64):
        out_j = getattr(jinv, name)([jnp.asarray(c) for c in comps])
        out_j = np.stack([np.asarray(c) for c in out_j])
    out_t = getattr(tinv, name)([torch.from_numpy(c) for c in comps])
    assert all(c.shape == (4, 5) for c in out_t)
    np.testing.assert_allclose(torch.stack(out_t).numpy(), out_j,
                               **tol(dtype))


def test_blockinv_scalar_refuses_other_sizes():
    with pytest.raises(NotImplementedError, match='16'):
        tinv.blockinv_scalar([torch.zeros(3)] * 16)


@pytest.mark.parametrize('dtype', DTYPES)
def test_chol3x3_matches_jax(dtype):
    M = spd_blocks(np.random.default_rng(3), 64, 3).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        L_j = np.asarray(jinv.chol3x3(jnp.asarray(M)))
    L_t = tinv.chol3x3(torch.from_numpy(M)).numpy()
    np.testing.assert_allclose(L_t, L_j, **tol(dtype))
    L = L_t.astype(np.float64)
    np.testing.assert_allclose(L @ np.swapaxes(L, -1, -2), M,
                               rtol=1e-5 if dtype == np.float32 else 1e-12)
    assert np.all(np.triu(L_t, 1) == 0)


@pytest.mark.parametrize('dtype', DTYPES)
def test_solve3x3_matches_jax(dtype):
    rng = np.random.default_rng(4)
    M = spd_blocks(rng, 64, 3).astype(dtype)
    b = rng.normal(size=(64, 3)).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        x_j = np.asarray(jinv.solve3x3(jnp.asarray(M), jnp.asarray(b)))
    x_t = tinv.solve3x3(torch.from_numpy(M), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(x_t, x_j, **tol(dtype))
    np.testing.assert_allclose(np.einsum('nij,nj->ni', M, x_t), b,
                               rtol=1e-4 if dtype == np.float32 else 1e-10,
                               atol=1e-5 if dtype == np.float32 else 1e-12)
