"""``lietensor/scalarized.py:bal_reproj_blocks`` against the JAX package's
on the same numpy inputs (float32 within 1e-6 of each array's largest
entry, float64 within 1e-12; the pinhole residual too), and against the
Jacobian the port's
autograd gives: ``torch.func.jacrev`` of ``optim.ba.reproj_residual_bal``
under a left retraction of the pose and a shift of the point, at zero
(float64 within 1e-10 of the largest entry).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from pypose_tpu.lietensor.scalarized import bal_reproj_blocks as jax_blocks
import pypose_tpu_torch as ppt
from pypose_tpu_torch.lietensor.scalarized import bal_reproj_blocks
from pypose_tpu.optim.ba import reproj_residual_pinhole as jax_pinhole
from pypose_tpu_torch.optim.ba import (reproj_residual_bal,
                                       reproj_residual_pinhole)

TOL = {np.float32: 1e-6, np.float64: 1e-12}


def _inputs(rng, O, dtype):
    """Cameras ~10 units from points in front of them (BAL looks down -z),
    f ~500, small radial distortion."""
    tangent = np.concatenate([rng.normal(size=(O, 3)) * 0.5,
                              rng.normal(size=(O, 3)) * 0.3], -1)
    T = ppt.se3(torch.as_tensor(tangent)).Exp().tensor().numpy()
    T[:, 2] -= 10.0
    X = rng.normal(size=(O, 3))
    cams = np.stack([500 + 50 * rng.random(O), 1e-3 * rng.normal(size=O),
                     1e-5 * rng.normal(size=O)], -1)
    pix = rng.normal(size=(O, 2)) * 30
    return [a.astype(dtype) for a in (T, X, cams, pix)]


def _close(got, want, tol, what):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_blocks_match_jax(dtype):
    args = _inputs(np.random.default_rng(0), 512, dtype)
    with jax.enable_x64(dtype == np.float64):
        want = jax_blocks(*[jnp.asarray(a) for a in args])
        got = bal_reproj_blocks(*[torch.as_tensor(a) for a in args])
        for name, g, w in zip(('r', 'Jc', 'Jp'), got, want):
            assert g.dtype == torch.from_numpy(args[0]).dtype
            _close(g.numpy(), np.asarray(w), TOL[dtype], name)


def test_blocks_match_autodiff():
    T, X, cams, pix = [torch.as_tensor(a) for a in
                       _inputs(np.random.default_rng(1), 64, np.float64)]
    r, Jc, Jp = bal_reproj_blocks(T, X, cams, pix)

    def one(t, x, c, p):
        def f(ec, ep):
            return reproj_residual_bal(ppt.SE3(t).add(ec), x + ep, c, p)
        z6 = torch.zeros(6, dtype=t.dtype)
        z3 = torch.zeros(3, dtype=t.dtype)
        return (f(z6, z3),) + torch.func.jacrev(f, argnums=(0, 1))(z6, z3)
    r_ad, Jc_ad, Jp_ad = torch.func.vmap(one)(T, X, cams, pix)
    for name, g, w in (('r', r, r_ad), ('Jc', Jc, Jc_ad), ('Jp', Jp, Jp_ad)):
        _close(g.numpy(), w.numpy(), 1e-10, name)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_pinhole_residual_matches_jax(dtype):
    T, X, cams, pix = _inputs(np.random.default_rng(2), 128, dtype)
    X[:, 2] += 20.0                   # in front of the pinhole camera
    cams[:, 1:] = 100.0 * cams[:, 1:]
    with jax.enable_x64(dtype == np.float64):
        import pypose_tpu as jpp
        want = jax.vmap(jax_pinhole)(jpp.SE3(jnp.asarray(T)),
                                     jnp.asarray(X), jnp.asarray(cams),
                                     jnp.asarray(pix))
        got = reproj_residual_pinhole(ppt.SE3(torch.as_tensor(T)),
                                      torch.as_tensor(X),
                                      torch.as_tensor(cams),
                                      torch.as_tensor(pix))
        _close(got.numpy(), np.asarray(want), TOL[dtype], 'pinhole')
