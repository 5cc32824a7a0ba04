"""The port's linear solvers against the JAX package's on identical numpy
inputs: the tree CG (``optim/solver.py:cg``) against
``jax.scipy.sparse.linalg.cg`` on dicts of arrays, with and without a
preconditioner, converged and cut at ``maxiter``; and the dense solvers
PINV, LSTSQ, Cholesky, CG and PCG.

Tolerances: float64 rtol 1e-9 (the same recursion; dot products summed
in another order); float32 rtol 1e-4.  Iteration counts are checked
against the stopping rule, which JAX does not report.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pypose_tpu.optim import solver as jsolver
from pypose_tpu_torch.optim import solver as tsolver


def spd(rng, n, cond=50.0):
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return (Q * np.geomspace(1.0, cond, n)) @ Q.T


def tree_problem(rng, dtype):
    """An SPD operator on the dict {'a': [20, 3], 'b': [8, 6]} (one dense
    matrix over the concatenation), a right-hand side and a Jacobi
    preconditioner."""
    A = spd(rng, 108)
    b = {'a': rng.normal(size=(20, 3)), 'b': rng.normal(size=(8, 6))}
    dinv = 1.0 / np.diag(A)
    return A.astype(dtype), {k: v.astype(dtype) for k, v in b.items()}, \
        dinv.astype(dtype)


def flat(x, lib):
    return lib.concatenate([x['a'].reshape(-1), x['b'].reshape(-1)])


def unflat(v):
    return {'a': v[:60].reshape(20, 3), 'b': v[60:].reshape(8, 6)}


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('precond', [False, True])
@pytest.mark.parametrize('maxiter', [7, 500])
def test_tree_cg_matches_jax(maxiter, precond, dtype):
    rng = np.random.default_rng(maxiter + precond)
    A, b, dinv = tree_problem(rng, dtype)
    tol = 1e-6 if dtype == np.float32 else 1e-10
    with jax.enable_x64(dtype == np.float64):
        Aj, dj = jnp.asarray(A), jnp.asarray(dinv)
        x_j, _ = jax.scipy.sparse.linalg.cg(
            lambda x: unflat(Aj @ flat(x, jnp)),
            {k: jnp.asarray(v) for k, v in b.items()}, tol=tol,
            maxiter=maxiter,
            M=(lambda x: unflat(dj * flat(x, jnp))) if precond else None)
        x_j = {k: np.asarray(v) for k, v in x_j.items()}
    At, dt = torch.from_numpy(A), torch.from_numpy(dinv)
    reads = tsolver.CG_HOST_READS
    x_t, k = tsolver.cg(
        lambda x: unflat(At @ flat(x, torch)),
        {k: torch.from_numpy(v) for k, v in b.items()}, tol=tol,
        maxiter=maxiter,
        M=(lambda x: unflat(dt * flat(x, torch))) if precond else None)
    assert 0 < k <= maxiter
    # one read a test: k passed, and one that stopped unless k hit maxiter
    assert tsolver.CG_HOST_READS - reads == k + (k < maxiter)
    if maxiter == 7:
        assert k == 7
    else:
        assert k < maxiter
        r = flat(b, np) - A.astype(np.float64) @ flat(
            {n: v.numpy() for n, v in x_t.items()}, np)
        assert np.linalg.norm(r) <= 2 * tol * np.linalg.norm(flat(b, np)) \
            + (1e-5 if dtype == np.float32 else 0)
    rtol = 1e-4 if dtype == np.float32 else 1e-9
    for n in b:
        np.testing.assert_allclose(x_t[n].numpy(), x_j[n], rtol=rtol,
                                   atol=rtol)


def test_tree_cg_zero_rhs_stops_at_once():
    x, k = tsolver.cg(lambda x: x, {'a': torch.zeros(5)})
    assert k == 0 and torch.equal(x['a'], torch.zeros(5))


@pytest.mark.parametrize('name', ['CG', 'PCG'])
@pytest.mark.parametrize('shape', [(30,), (30, 1)])
def test_dense_cg_matches_jax(name, shape):
    rng = np.random.default_rng(len(shape))
    A = spd(rng, 30)
    b = rng.normal(size=shape)
    with jax.enable_x64(True):
        x_j = np.asarray(getattr(jsolver, name)(tol=1e-12)(
            jnp.asarray(A), jnp.asarray(b)))
    x_t = getattr(tsolver, name)(tol=1e-12)(torch.from_numpy(A),
                                            torch.from_numpy(b))
    assert x_t.shape == b.shape
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(A @ x_t.numpy(), b, atol=1e-9)


def test_dense_solvers_match_jax():
    """PINV, LSTSQ (one system and a batch) and Cholesky in float64; a
    matrix that is not positive definite gives NaN from Cholesky."""
    rng = np.random.default_rng(9)
    A = spd(rng, 12)
    b = rng.normal(size=(12,))
    Ab = rng.normal(size=(4, 12, 5))
    bb = rng.normal(size=(4, 12))
    with jax.enable_x64(True):
        want = dict(
            pinv=jsolver.PINV()(jnp.asarray(A), jnp.asarray(b)),
            lstsq=jsolver.LSTSQ()(jnp.asarray(A), jnp.asarray(b)),
            lstsq_b=jsolver.LSTSQ()(jnp.asarray(Ab), jnp.asarray(bb)),
            chol=jsolver.Cholesky()(jnp.asarray(A), jnp.asarray(b)[:, None]))
        want = {k: np.asarray(v) for k, v in want.items()}
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    got = dict(pinv=tsolver.PINV()(At, bt), lstsq=tsolver.LSTSQ()(At, bt),
               lstsq_b=tsolver.LSTSQ()(torch.from_numpy(Ab),
                                       torch.from_numpy(bb)),
               chol=tsolver.Cholesky()(At, bt[:, None]))
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-9,
                                   atol=1e-10, err_msg=k)
    bad = tsolver.Cholesky()(-At, bt)
    assert torch.isnan(bad).all()
