"""make_batch_optimizer, StopOnPlateau, GaussNewton.optimize, modjac and
models with several or mixed parameters of the port against the JAX
package, the second half of the tests/optim/test_optimizer.py mirror
(test_torch_optimizer.py holds the first and the shared helpers).

Tolerances as in test_torch_optimizer.py: per-step losses within 1e-4
relative plus 1e-9 absolute in float32, 1e-8 relative in float64;
parameters within 1e-5 (float32) and 1e-10 (float64); the Jacobian of
PoseInv within 1e-6 (float32) and 1e-12 (float64); each test names its
own where it differs.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu as jpp
from pypose_tpu.optim import strategy as jstrat
from pypose_tpu.optim.scheduler import StopOnPlateau as JStop
import pypose_tpu_torch as pp
from pypose_tpu_torch.optim import strategy as tstrat
from pypose_tpu_torch.optim.scheduler import StopOnPlateau

from test_torch_optimizer import (LOSS_TOL, PARAM_TOL, JPoseInv, TPoseInv,
                                  draw)


def test_scheduler_stop_on_plateau():
    pose, inp = draw((2, 2), 6)
    with jax.enable_x64(False):
        jo = jpp.optim.LM(JPoseInv(pose), strategy=jstrat.TrustRegion(1e4))
        js = JStop(jo, steps=20, patience=3, decreasing=1e-9)
        jl = js.optimize(input=jpp.SE3(jnp.asarray(inp)))
    tm = TPoseInv(pose)
    to = pp.optim.LM(tm, strategy=tstrat.TrustRegion(radius=1e4))
    ts = StopOnPlateau(to, steps=20, patience=3, decreasing=1e-9)
    tl = ts.optimize(input=pp.SE3(torch.from_numpy(inp)))
    assert tl < 1e-8 and ts.steps < 20 and ts.steps == js.steps
    np.testing.assert_allclose(to.history, jo.history, rtol=1e-4, atol=1e-9)


def test_multiple_params():
    with jax.enable_x64(False):
        k1, k2 = jax.random.split(jax.random.PRNGKey(8))
        p1 = np.array(jpp.randn_se3(2, sigma=0.4, key=k1).tensor())
        p2 = np.array(jpp.randn_se3(2, sigma=0.4, key=k2).tensor())
        inp = np.array(jpp.randn_SE3(2, key=jax.random.PRNGKey(9)).tensor())

    def model(lib, mod):
        class TwoPose(lib.Module):
            def __init__(self):
                super().__init__()
                self.p2 = lib.Parameter(lib.se3(mod.asarray(p2)
                                                if mod is jnp else
                                                torch.from_numpy(p2)))
                self.p1 = lib.Parameter(lib.se3(mod.asarray(p1)
                                                if mod is jnp else
                                                torch.from_numpy(p1)))

            def forward(self, input):
                return ((self.p1.Exp() @ self.p2.Exp() @ input).Log()
                        .tensor(), self.p2.Exp().Log().tensor())
        return TwoPose()

    jm = model(jpp, jnp)
    jo = jpp.optim.LM(jm)
    jl = [jo.step(jpp.SE3(jnp.asarray(inp))) for _ in range(10)]
    tm = model(pp, torch)
    to = pp.optim.LM(tm)
    tl = [to.step(pp.SE3(torch.from_numpy(inp))) for _ in range(10)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-9)
    assert tl[-1] < 1e-7
    for n in ('p1', 'p2'):
        np.testing.assert_allclose(
            getattr(tm, n).tensor().detach().numpy(),
            np.asarray(getattr(jm, n).tensor()), atol=1e-5)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_euclidean_and_lie_params(dtype):
    """An so3 and a Euclidean parameter.  J^T J is singular here (9
    residuals, 12 parameters: rotation and bias trade off), so the damped
    solve's null-space part carries float32 rounding at the scale of the
    condition number (the first step's loss differs by 0.3% between the
    packages): float32 holds convergence, float64 the JAX package's
    steps (1e-6) and parameters (1e-6)."""
    with jax.enable_x64(dtype == 'float64'):
        dt = getattr(jnp, dtype)
        pose = np.array(jpp.randn_so3(3, sigma=0.4, dtype=dt,
                                      key=jax.random.PRNGKey(10)).tensor())
        inp = np.array(jpp.randn_SO3(3, key=jax.random.PRNGKey(11),
                                     dtype=dt).tensor())
    one = np.ones(3, dtype)

    def model(lib, mk):
        class Mixed(lib.Module):
            def __init__(self):
                super().__init__()
                self.pose = lib.Parameter(lib.so3(mk(pose)))
                self.bias = lib.Parameter(mk(one))

            def forward(self, input):
                return (self.pose.Exp() @ input).Act(mk(one)) + self.bias
        return Mixed()
    with jax.enable_x64(dtype == 'float64'):
        jm = model(jpp, jnp.asarray)
        jx = jpp.SO3(jnp.asarray(inp))
        jo = jpp.optim.LM(jm)
        jl = [jo.step(jx, target=jx.Act(jnp.asarray(one)))
              for _ in range(10)]
        jbias = np.asarray(jm.bias)
    tm = model(pp, torch.tensor)
    tx = pp.SO3(torch.from_numpy(inp))
    to = pp.optim.LM(tm)
    tl = [to.step(tx, target=tx.Act(torch.from_numpy(one)))
          for _ in range(10)]
    assert tl[-1] < 1e-7 and jl[-1] < 1e-7
    if dtype == 'float64':
        np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=1e-20)
        np.testing.assert_allclose(tm.bias.detach().numpy(), jbias,
                                   atol=1e-6)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_batch_optimize(dtype):
    """128 independent problems in one torch.func.vmap, against the JAX
    package's jax.vmap: per-problem losses and parameters."""
    B = 128
    with jax.enable_x64(dtype == 'float64'):
        dt = getattr(jnp, dtype)
        tg = np.array(jpp.randn_SE3(B, 1, sigma=0.5, dtype=dt,
                                    key=jax.random.PRNGKey(42)).tensor())

        class JB(jpp.Module):
            def __init__(self):
                super().__init__()
                self.pose = jpp.Parameter(jpp.identity_se3(1, dtype=dt))

            def forward(self, input):
                return (self.pose.Exp() @ input).Log().tensor()
        jp, jl = jpp.optim.batch_optimize(
            JB(), jpp.SE3(jnp.asarray(tg)), steps=4,
            strategy=jstrat.Constant(damping=1e-6))
        jp, jl = np.array(jp['pose'].tensor()), np.array(jl)
    from pypose_tpu_torch.testing import PoseInvB
    tp, tl = pp.optim.batch_optimize(
        PoseInvB().to(getattr(torch, dtype)), pp.SE3(torch.from_numpy(tg)),
        steps=4, strategy=tstrat.Constant(damping=1e-6))
    assert tl.shape == (B,) and tp['pose'].shape == (B, 1, 6)
    assert float(tl.max()) < 1e-8
    rtol, atol = LOSS_TOL[dtype]
    np.testing.assert_allclose(tl.numpy(), jl, rtol=rtol, atol=atol)
    np.testing.assert_allclose(tp['pose'].tensor().numpy(), jp,
                               atol=PARAM_TOL[dtype])


def test_batch_optimizer_with_target_and_weight():
    """make_batch_optimizer over (input, target, weight) triples, each
    problem against its own step() run."""
    B = 6
    pose, inp = draw((B, 1), 12)
    tgt = np.asarray(draw((B, 1), 13)[1])
    w = np.broadcast_to(np.diag(np.arange(1, 7)).astype(np.float32),
                        (B, 1, 6, 6)).copy()

    class Rel(pp.Module):
        def __init__(self):
            super().__init__()
            self.pose = pp.Parameter(pp.identity_se3(1))

        def forward(self, input):
            return (self.pose.Exp() @ input).Log().tensor()
    solve = pp.optim.make_batch_optimizer(
        Rel(), steps=3, strategy=tstrat.TrustRegion(radius=1e3),
        has_target=True, has_weight=True)
    x, t, wt = (pp.SE3(torch.from_numpy(inp)),
                pp.SE3(torch.from_numpy(tgt)).Log().tensor(),
                torch.from_numpy(w))
    params, losses = solve(x, t, wt)
    for b in range(B):
        m = Rel()
        o = pp.optim.LM(m, strategy=tstrat.TrustRegion(radius=1e3))
        for _ in range(3):
            loss = o.step(x[b], target=t[b], weight=wt[b])
        np.testing.assert_allclose(float(losses[b]), loss, rtol=1e-5,
                                   atol=1e-9)
        np.testing.assert_allclose(params['pose'].tensor()[b].numpy(),
                                   m.pose.tensor().detach().numpy(),
                                   atol=1e-5)


def test_scheduler_device_delegation_matches_host():
    """StopOnPlateau.optimize hands the loop to LM.optimize (one host
    read); host stepping gives the same losses and parameters."""
    pose, inp = draw((2, 2), 0, sigma=1.0)
    x = pp.SE3(torch.from_numpy(inp))
    m1 = TPoseInv(pose)
    o1 = pp.optim.LM(m1, strategy=tstrat.TrustRegion(radius=1e4))
    l1 = StopOnPlateau(o1, steps=10, patience=3).optimize(input=x)
    m2 = TPoseInv(pose)
    o2 = pp.optim.LM(m2, strategy=tstrat.TrustRegion(radius=1e4))
    s2 = StopOnPlateau(o2, steps=10, patience=3, verbose=False)
    hist = []
    while s2.continual():
        hist.append(o2.step(x))
        s2.step(hist[-1])
    assert l1 < 1e-10 and o2.loss < 1e-10
    np.testing.assert_allclose(o1.history, hist, rtol=1e-5, atol=1e-12)
    assert torch.allclose(m1.pose.tensor(), m2.pose.tensor(), atol=1e-5)


def test_gn_optimize_matches_jax():
    """GaussNewton.optimize (the loop EPnP's refinement runs,
    ``_optimize_run``) against the JAX package's: history, steps and
    parameters."""
    pose, inp = draw((2, 2), 14)
    jm = JPoseInv(pose)
    jo = jpp.optim.GN(jm)
    jo.optimize(jpp.SE3(jnp.asarray(inp)), steps=8, patience=2,
                decreasing=1e-9)
    tm = TPoseInv(pose)
    to = pp.optim.GN(tm)
    to.optimize(pp.SE3(torch.from_numpy(inp)), steps=8, patience=2,
                decreasing=1e-9)
    assert len(to.history) == len(jo.history) < 8
    np.testing.assert_allclose(to.history, jo.history, rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(tm.pose.tensor().detach().numpy(),
                               np.asarray(jm.pose.tensor()), atol=1e-5)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_modjac_matches_jax(dtype):
    """modjac (flat and per output), modjacrev and modjacfwd of PoseInv
    against the JAX package's, and the LieTensor-group columns' zero
    tail."""
    pose, inp = draw((2, 1), 15, dtype)
    with jax.enable_x64(dtype == 'float64'):
        jm = JPoseInv(pose)
        jx = jpp.SE3(jnp.asarray(inp))
        want = np.asarray(jpp.optim.modjac(jm, jx, flatten=True))
        want_rev = np.asarray(jpp.optim.modjacrev(jm, jx)['pose'].tensor())
    tm = TPoseInv(pose)
    tx = pp.SE3(torch.from_numpy(inp))
    tol = 1e-6 if dtype == 'float32' else 1e-12
    got = pp.optim.modjac(tm, tx, flatten=True)
    np.testing.assert_allclose(got.numpy(), want, atol=tol)
    assert len(pp.optim.modjac(tm, tx)) == 1
    rev = pp.optim.modjacrev(tm, tx)['pose'].tensor()
    fwd = pp.optim.modjacfwd(tm, tx)['pose'].tensor()
    np.testing.assert_allclose(rev.numpy(), want_rev, atol=tol)
    np.testing.assert_allclose(fwd.numpy(), want_rev, atol=tol * 10)

    class G(pp.Module):
        def __init__(self):
            super().__init__()
            self.T = pp.Parameter(pp.se3(torch.from_numpy(pose)).Exp())

        def forward(self, input):
            return (self.T @ input).Log().tensor()
    J = pp.optim.modjac(G(), tx, flatten=True)
    assert J.shape == (12, 14)
    assert float(J.reshape(12, 2, 7)[..., 6].abs().max()) == 0.0

