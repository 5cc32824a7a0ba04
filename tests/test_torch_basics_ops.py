"""basics/ops.py of the port against the JAX package on the same numpy
inputs: pm, cumops/cummul/cumprod (left and right, batched, SE3 and the
scalarized SO3 scan), their gradients, the in-place aliases, and the
associative scan against ``jax.lax.associative_scan`` for
non-commutative ops, forward and reverse.

Tolerances.  The scan combines in JAX's order, so with JAX's eager
elementwise ops (no jit) the quaternion scan agrees to the bit; the
group scans against the JAX package's results within 1e-5 (float32; its
SE3 products are jitted XLA programs that contract products into FMAs)
and 1e-12 (float64); gradients within 1e-4 relative (float32) and 1e-10
(float64).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu as jpp
from pypose_tpu.lietensor.scalarized import _qmul as jqmul
import pypose_tpu_torch as pp
from pypose_tpu_torch.basics.ops import associative_scan
from pypose_tpu_torch.lietensor.scalarized import _qmul as tqmul
from pypose_tpu_torch.testing import cap_threads

cap_threads()

DTYPES = ['float32', 'float64']
TOL = {'float32': 1e-5, 'float64': 1e-12}


def jax_group(kind, shape, seed, dtype):
    """A JAX-package random group element, as numpy of ``dtype``."""
    with jax.enable_x64(dtype == 'float64'):
        X = getattr(jpp, 'randn_' + kind)(*shape, key=jax.random.PRNGKey(seed),
                                          dtype=getattr(jnp, dtype))
        return np.array(X.tensor())


def both(kind, arr):
    return (getattr(jpp, kind)(jnp.asarray(arr)),
            getattr(pp, kind)(torch.from_numpy(arr)))


def test_pm():
    x = np.array([0.1, 0.0, -0.2, -0.0], np.float32)
    np.testing.assert_array_equal(pp.pm(torch.from_numpy(x)).numpy(),
                                  np.asarray(jpp.pm(jnp.asarray(x))))
    np.testing.assert_array_equal(pp.pm(torch.from_numpy(x)).numpy(),
                                  [1., 1., -1., 1.])


def _sequential(X, left):
    outs = [X[0]]
    acc = X[0]
    for i in range(1, len(X)):
        acc = (X[i] @ acc) if left else (acc @ X[i])
        outs.append(acc)
    return np.stack([o.tensor().numpy() for o in outs])


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('kind', ['SE3', 'SO3', 'Sim3', 'RxSO3'])
def test_cumprod_left_right_matches_jax(kind, dtype):
    arr = jax_group(kind, (7,), 0, dtype)
    with jax.enable_x64(dtype == 'float64'):
        JX, TX = both(kind, arr)
        for left in (True, False):
            want = np.asarray(jpp.cumprod(JX, dim=0, left=left).tensor())
            got = pp.cumprod(TX, dim=0, left=left).tensor().numpy()
            np.testing.assert_allclose(got, want, atol=TOL[dtype])
            np.testing.assert_allclose(got, _sequential(TX, left),
                                       atol=TOL[dtype] * 10)


@pytest.mark.parametrize('dtype', DTYPES)
def test_cummul_equals_cumprod_for_groups(dtype):
    _, TX = both('SO3', jax_group('SO3', (5,), 1, dtype))
    for left in (True, False):
        a = pp.cummul(TX, dim=0, left=left).tensor().numpy()
        b = pp.cumprod(TX, dim=0, left=left).tensor().numpy()
        np.testing.assert_array_equal(a, b)
    _, TS = both('SE3', jax_group('SE3', (5,), 1, dtype))
    np.testing.assert_allclose(pp.cummul(TS, dim=0).tensor().numpy(),
                               pp.cumprod(TS, dim=0).tensor().numpy(),
                               atol=TOL[dtype])


@pytest.mark.parametrize('dtype', DTYPES)
def test_cumprod_batched_dim1(dtype):
    arr = jax_group('SO3', (2, 6), 2, dtype)
    with jax.enable_x64(dtype == 'float64'):
        JX, TX = both('SO3', arr)
        want = np.asarray(jpp.cumprod(JX, dim=1, left=False).tensor())
    out = pp.cumprod(TX, dim=1, left=False)
    assert tuple(out.lshape) == (2, 6)
    np.testing.assert_allclose(out.tensor().numpy(), want, atol=TOL[dtype])
    for b in range(2):
        np.testing.assert_allclose(out[b].tensor().numpy(),
                                   _sequential(TX[b], False),
                                   atol=TOL[dtype] * 10)
    # the storage dimension cannot be scanned
    with pytest.raises(AssertionError):
        pp.cumprod(TX, dim=2)


@pytest.mark.parametrize('dtype', DTYPES)
def test_cumops_custom(dtype):
    arr = np.random.default_rng(3).normal(size=(6, 3)).astype(dtype)
    with jax.enable_x64(dtype == 'float64'):
        want = np.asarray(jpp.cumops(jpp.so3(jnp.asarray(arr)), 0,
                                     lambda a, b: a + b.tensor()).tensor())
    got = pp.cumops(pp.so3(torch.from_numpy(arr)), 0,
                    lambda a, b: a + b.tensor()).tensor().numpy()
    np.testing.assert_allclose(got, want, atol=TOL[dtype])
    np.testing.assert_allclose(got, np.cumsum(arr, 0), atol=TOL[dtype])


@pytest.mark.parametrize('dtype', DTYPES)
def test_cumprod_grad_matches_jax(dtype):
    """Gradient of sum(Log(cumprod(X))^2) with respect to SO3 storage
    (left-tangent entries, zero tail in both packages)."""
    arr = jax_group('SO3', (8,), 4, dtype)
    with jax.enable_x64(dtype == 'float64'):
        g = jax.grad(lambda X: jnp.sum(
            jpp.cumprod(X, dim=0).Log().tensor() ** 2))(
                jpp.SO3(jnp.asarray(arr)))
        want = np.asarray(g.tensor())
    got = torch.func.grad(lambda X: torch.sum(
        pp.cumprod(X, dim=0).Log().tensor() ** 2))(
            pp.SO3(torch.from_numpy(arr)))
    assert got.ltype is pp.SO3(torch.zeros(4)).ltype
    assert np.isfinite(got.tensor().numpy()).all()
    rtol = 1e-4 if dtype == 'float32' else 1e-10
    np.testing.assert_allclose(got.tensor().numpy(), want, rtol=rtol,
                               atol=rtol)


def test_inplace_aliases_return_new():
    X = pp.SE3(torch.from_numpy(jax_group('SE3', (4,), 5, 'float32')))
    a = 0.1 * torch.ones(4, 7)
    assert torch.allclose(X.add(a).tensor(), pp.add(X, a).tensor())
    assert torch.equal(X.cumprod_(0).tensor(), X.cumprod(0).tensor())
    assert torch.equal(X.cummul_(0).tensor(), X.cummul(0).tensor())
    assert torch.equal(X.cumops_(0, lambda x, y: x @ y).tensor(),
                       X.cumops(0, lambda x, y: x @ y).tensor())
    assert pp.cumprod_ is pp.cumprod and pp.cummul_ is pp.cummul \
        and pp.cumops_ is pp.cumops


def _mat2(a, b):
    """2x2 matrix product on four component arrays (non-commutative)."""
    a00, a01, a10, a11 = a
    b00, b01, b10, b11 = b
    return (a00 * b00 + a01 * b10, a00 * b01 + a01 * b11,
            a10 * b00 + a11 * b10, a10 * b01 + a11 * b11)


@pytest.mark.parametrize('op', ['qmul', 'mat2'])
@pytest.mark.parametrize('n', [1, 2, 3, 5, 8, 13, 64, 257])
def test_associative_scan_matches_jax(op, n):
    """The same combine order as jax.lax.associative_scan (eager JAX
    ops): bit-equal, forward and reverse, over axis 1 of [3, n]
    components; unit quaternions for qmul, matrices near I for mat2."""
    rng = np.random.default_rng(n)
    if op == 'qmul':
        q = rng.normal(size=(4, 3, n))
        x = (q / np.linalg.norm(q, axis=0)).astype(np.float32)
        jf, tf = jqmul, tqmul
    else:
        x = (np.eye(2).reshape(4, 1, 1)
             + 0.1 * rng.normal(size=(4, 3, n))).astype(np.float32)
        jf, tf = _mat2, _mat2
    for rev in (False, True):
        want = jax.lax.associative_scan(
            jf, tuple(jnp.asarray(c) for c in x), axis=1, reverse=rev)
        got = associative_scan(tf, tuple(torch.from_numpy(c) for c in x),
                               dim=1, reverse=rev)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_associative_scan_single_tensor_and_dim():
    x = torch.arange(24.).reshape(2, 3, 4)
    for d in range(3):
        np.testing.assert_array_equal(
            associative_scan(torch.add, x, dim=d).numpy(),
            np.asarray(jax.lax.associative_scan(jnp.add, jnp.asarray(
                x.numpy()), axis=d)))
    np.testing.assert_array_equal(
        associative_scan(torch.add, torch.arange(4.), reverse=True).numpy(),
        [6., 6., 5., 3.])
