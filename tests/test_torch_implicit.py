"""optim.implicit.least_squares of the port against the JAX package
(tests/optim/test_implicit.py): the solve, its implicit-function-theorem
gradient against ``jax.grad`` and against central finite differences,
a Euclidean line fit against its closed-form gradient, and composition
with ``torch.func.vmap`` (as the JAX test composes with jit and vmap).

Tolerances: the solutions within 1e-5 (float32) and 1e-10 (float64) of
the JAX package's; gradients within 1e-4 relative of JAX's in float32,
1e-8 in float64; the finite difference (eps 1e-3 in float32, 1e-6 in
float64, central) within 5e-3 and 1e-6 relative; the line fit's gradient
within 1e-4 of (t - mean t) / sum (t - mean t)^2.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu as jpp
from pypose_tpu.optim.implicit import least_squares as jls
import pypose_tpu_torch as pp
from pypose_tpu_torch.optim.implicit import least_squares

DTYPES = ['float32', 'float64']


def jres(theta, x):
    return (theta['T'] @ jpp.SE3(x)).Log().tensor()


def tres(theta, x):
    return (theta['T'] @ pp.SE3(x)).Log().tensor()


def draw(seed, dtype, n=()):
    with jax.enable_x64(dtype == 'float64'):
        return np.array(jpp.randn_SE3(*n, sigma=0.5, dtype=getattr(
            jnp, dtype), key=jax.random.PRNGKey(seed)).tensor())


@pytest.mark.parametrize('dtype', DTYPES)
def test_solves_to_inverse(dtype):
    inp = draw(0, dtype)
    with jax.enable_x64(dtype == 'float64'):
        jsol = np.asarray(jls(jres, {'T': jpp.identity_SE3(
            dtype=getattr(jnp, dtype))}, jnp.asarray(inp), steps=8)['T']
            .tensor())
    sol = least_squares(tres, {'T': pp.identity_SE3(
        dtype=getattr(torch, dtype))}, torch.from_numpy(inp), steps=8)
    err = (sol['T'] @ pp.SE3(torch.from_numpy(inp))).Log().tensor()
    assert float(err.abs().max()) < (1e-6 if dtype == 'float32' else 1e-12)
    assert sol['T'].ltype is pp.identity_SE3().ltype
    np.testing.assert_allclose(sol['T'].tensor().numpy(), jsol,
                               atol=1e-5 if dtype == 'float32' else 1e-10)


@pytest.mark.parametrize('dtype', DTYPES)
def test_gradient_matches_jax_and_fd(dtype):
    """d/dx of |Log(T*(x))|^2, T* = argmin |Log(T x)|^2 (so T* = x^-1):
    against jax.grad, and along a random retraction direction against a
    central finite difference."""
    f32 = dtype == 'float32'
    inp = draw(1, dtype)
    with jax.enable_x64(not f32):
        jt0 = {'T': jpp.identity_SE3(dtype=getattr(jnp, dtype))}
        want = np.asarray(jax.grad(lambda x: jnp.sum(
            jls(jres, jt0, x, steps=8)['T'].Log().tensor() ** 2))(
                jnp.asarray(inp)))
    t0 = {'T': pp.identity_SE3(dtype=getattr(torch, dtype))}

    def loss(x):
        s = least_squares(tres, t0, x, steps=8)
        return torch.sum(s['T'].Log().tensor() ** 2)
    x = torch.from_numpy(inp).requires_grad_()
    loss(x).backward()
    g = x.grad
    tol = 1e-4 if f32 else 1e-8
    np.testing.assert_allclose(g.numpy(), want, rtol=tol, atol=tol * np.abs(
        want).max())
    # the same through torch.func.grad
    np.testing.assert_allclose(torch.func.grad(loss)(
        torch.from_numpy(inp)).numpy(), g.numpy(), rtol=1e-6, atol=1e-7)
    delta = torch.from_numpy(np.random.default_rng(0).normal(size=6).astype(
        dtype))
    eps = 1e-3 if f32 else 1e-6
    X = pp.SE3(torch.from_numpy(inp))

    def moved(e):
        return (pp.se3(e * delta).Exp() @ X).tensor()
    fd = (loss(moved(eps)) - loss(moved(-eps))) / (2 * eps)
    _, dstorage = torch.func.jvp(moved, (torch.zeros((), dtype=getattr(
        torch, dtype)),), (torch.ones((), dtype=getattr(torch, dtype)),))
    an = torch.dot(g, dstorage)
    np.testing.assert_allclose(float(an), float(fd),
                               rtol=5e-3 if f32 else 1e-6)


def test_euclidean_curve_fit_gradient():
    """d(slope)/d(data) of a least-squares line fit."""
    t = torch.linspace(0, 1, 20)
    y = 2.0 * t + 1.0 + 0.01 * torch.from_numpy(
        np.random.default_rng(2).normal(size=20).astype(np.float32))

    def residual(theta, y):
        return theta['ab'][0] * t + theta['ab'][1] - y

    def loss(y):
        return least_squares(residual, {'ab': torch.zeros(2)}, y,
                             steps=5)['ab'][0]
    g = torch.func.grad(loss)(y)
    tc = t - t.mean()
    np.testing.assert_allclose(g.numpy(), (tc / torch.sum(tc * tc)).numpy(),
                               atol=1e-4)
    ab = least_squares(residual, {'ab': torch.zeros(2)}, y, steps=5)['ab']
    want = jls(lambda th, yy: th['ab'][0] * jnp.asarray(t.numpy())
               + th['ab'][1] - yy, {'ab': jnp.zeros(2)},
               jnp.asarray(y.numpy()), steps=5)['ab']
    np.testing.assert_allclose(ab.numpy(), np.asarray(want), atol=1e-5)


def test_vmap_composes():
    """torch.func.vmap over five problems (the JAX test's jit and vmap),
    each against its own solve, and grad through the vmapped solve."""
    inps = torch.from_numpy(draw(3, 'float32', (5,)))
    theta0 = {'T': pp.identity_SE3()}

    def solve_one(x):
        return least_squares(tres, theta0, x, steps=6)['T'].tensor()
    out = torch.func.vmap(solve_one)(inps)
    err = (pp.SE3(out) @ pp.SE3(inps)).Log().tensor()
    assert float(err.abs().max()) < 1e-5
    for b in range(5):
        np.testing.assert_allclose(out[b].numpy(), solve_one(inps[b]).numpy(),
                                   atol=1e-6)
    g = torch.func.grad(lambda xs: torch.sum(pp.SE3(torch.func.vmap(
        solve_one)(xs)).Log().tensor() ** 2))(inps)
    for b in range(5):
        gb = torch.func.grad(lambda x: torch.sum(pp.SE3(solve_one(x)).Log()
                                                 .tensor() ** 2))(inps[b])
        np.testing.assert_allclose(g[b].numpy(), gb.numpy(), rtol=1e-5,
                                   atol=1e-6)
