"""``pypose_tpu_torch.nn`` (``Parameter``, ``Module``, ``functional_call``)
and ``func.jacrev``/``jacfwd`` against the JAX package's ``nn`` and
``func`` on the same numpy inputs (CPU, float64), and the SKILL's first
flow: an SE3 fitted to point correspondences by gradient steps with a
left retraction, its gradient held to ``jax.grad`` at every step within
1e-10 (1 + max|g|).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu as jpp
from pypose_tpu import nn as jnn
import pypose_tpu_torch as ppt
from pypose_tpu_torch import func as tfunc
from pypose_tpu_torch import nn as tnn
from pypose_tpu_torch.testing import cap_threads

cap_threads()

TOL = 1e-10


def close(got, want):
    got = got.tensor() if isinstance(got, ppt.LieTensor) else got
    want = np.asarray(want.tensor() if isinstance(want, jpp.LieTensor)
                      else want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=TOL * (1 + np.abs(want).max()))


def correspondences(n=40, seed=0):
    """(truth storage [7], points [n, 3], targets [n, 3]) in float64: the
    truth is the JAX package's Exp of a random se3, the targets its
    action."""
    rng = np.random.default_rng(seed)
    with jax.enable_x64(True):
        T = jpp.se3(jnp.asarray(rng.normal(size=6) * [1, 1, 1, .5, .5, .5])
                    ).Exp()
        P = rng.normal(size=(n, 3))
        return np.asarray(T.tensor()), P, np.asarray(T.Act(jnp.asarray(P)))


class TorchPose(tnn.Module):
    def __init__(self, T):
        super().__init__()
        self.T = tnn.Parameter(ppt.SE3(torch.tensor(T)))
        self.bias = tnn.Parameter(torch.zeros(3, dtype=torch.float64))

    def forward(self, p):
        return self.T.Act(p) + self.bias


class JaxPose(jnn.Module):
    def __init__(self, T):
        super().__init__()
        self.T = jnn.Parameter(jpp.SE3(jnp.asarray(T)))
        self.bias = jnn.Parameter(jnp.zeros(3))

    def forward(self, p):
        return self.T.Act(p) + self.bias


def test_parameter_and_module():
    """A LieTensor Parameter keeps its ltype and registers its storage as a
    ``torch.nn.Parameter`` (requires_grad True); a tensor Parameter is a
    ``torch.nn.Parameter``; ``named_parameters`` lists both."""
    T = ppt.identity_SE3(dtype=torch.float64)
    p = tnn.Parameter(T)
    assert isinstance(p, ppt.LieTensor) and p.ltype is T.ltype
    assert isinstance(p.tensor(), torch.nn.Parameter) and p.requires_grad
    e = tnn.Parameter(torch.zeros(3))
    assert type(e) is torch.nn.Parameter and e.requires_grad
    m = TorchPose(T.tensor().numpy())
    assert isinstance(m, torch.nn.Module)
    assert isinstance(m.T, tnn.Parameter) and m.T.ltype.name == 'SE3'
    names = dict(m.named_parameters())
    assert set(names) == {'T', 'bias'}
    assert names['T'] is m.T.tensor()


def test_grad_and_functional_call_match_jax():
    """``.grad`` after ``backward`` (left-tangent entries, zero tail) and
    ``torch.func.grad`` through ``functional_call`` equal ``jax.grad``
    through the JAX package's ``functional_call``."""
    T0, P, Q = correspondences()
    T1 = correspondences(seed=1)[0]
    tm = TorchPose(T0)
    Pt, Qt = torch.from_numpy(P), torch.from_numpy(Q)
    ((tm(Pt) - Qt) ** 2).sum().backward()
    with jax.enable_x64(True):
        jm = JaxPose(T0)
        jv0 = jm(jnp.asarray(P))
        jg = jax.grad(lambda ps: jnp.sum(
            (jnn.functional_call(jm, ps, jnp.asarray(P)) - Q) ** 2))(
            jm.parameters())
        params1 = {'T': jpp.SE3(jnp.asarray(T1)), 'bias': jnp.ones(3)}
        jv1 = jnn.functional_call(jm, params1, jnp.asarray(P))
        jg1 = jax.grad(lambda ps: jnp.sum(
            (jnn.functional_call(jm, ps, jnp.asarray(P)) - Q) ** 2))(params1)
    close(tm.T.grad, jg['T'])
    close(tm.bias.grad, jg['bias'])
    assert float(tm.T.grad[-1]) == 0.0
    tparams1 = {'T': ppt.SE3(torch.from_numpy(T1)),
                'bias': torch.ones(3, dtype=torch.float64)}
    close(tnn.functional_call(tm, tparams1, Pt), jv1)
    tg1 = torch.func.grad(lambda ps: ((tnn.functional_call(tm, ps, Pt)
                                       - Qt) ** 2).sum())(tparams1)
    assert isinstance(tg1['T'], ppt.LieTensor) and tg1['T'].ltype.name == \
        'SE3'
    close(tg1['T'], jg1['T'])
    close(tg1['bias'], jg1['bias'])
    # the module's own parameters are back after the call
    close(tm(Pt), jv0)


def test_fit_se3_by_gradient_steps():
    """The SKILL's flow 1: T <- Retr(T, -lr grad) from the identity, 25
    steps, gradients held to ``jax.grad`` at every step; the fit reaches
    the truth."""
    truth, P, Q = correspondences(n=30, seed=2)
    Pt, Qt = torch.from_numpy(P), torch.from_numpy(Q)
    m = TorchPose(np.array([0., 0., 0., 0., 0., 0., 1.]))
    lr = 0.4
    with jax.enable_x64(True):
        Tj = jpp.identity_SE3(dtype=jnp.float64)

        def loss(T):
            return jnp.mean(jnp.sum((T.Act(jnp.asarray(P)) - Q) ** 2, -1))
        for _ in range(25):
            m.zero_grad()
            torch.mean(((m.T.Act(Pt) - Qt) ** 2).sum(-1)).backward()
            gj = jax.grad(loss)(Tj)
            close(m.T.grad, gj)
            Tj = Tj + (-lr) * gj.tensor()
            with torch.no_grad():
                m.T.tensor().copy_(m.T.add(-lr * m.T.grad).tensor())
            close(m.T, Tj)
    err = (m.T.detach().Inv() @ ppt.SE3(torch.from_numpy(truth))).Log()
    err = err.tensor()
    assert float(err.abs().max()) < 1e-4


@pytest.mark.parametrize('mode', ['jacrev', 'jacfwd'])
def test_func_jacobians_match_jax(mode):
    """``func.jacrev``/``jacfwd`` of a LieTensor-valued function of a
    LieTensor: the Jacobian keeps the output's and the input's ltypes
    (nested, as the JAX package's pytrees nest) and equals JAX's."""
    T0, P, _ = correspondences(n=4)
    with jax.enable_x64(True):
        want = getattr(jpp.func, mode)(
            lambda T: (T @ T).Log())(jpp.SE3(jnp.asarray(T0)))
    got = getattr(tfunc, mode)(lambda T: (T @ T).Log())(
        ppt.SE3(torch.from_numpy(T0)))
    assert got.ltype.name == 'se3' and got.tensor().ltype.name == 'SE3'
    close(got.tensor().tensor(), want.tensor().tensor())
