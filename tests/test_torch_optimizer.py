"""GN and LM of the port against the JAX package, mirroring
tests/optim/test_optimizer.py (with test_torch_optimizer_solvers.py and
test_torch_optimizer_batch.py, which import the helpers here): each
problem is drawn by the JAX package and handed to both packages as
numpy, both run the same steps, and the port is held to the JAX
package's per-step losses, rejections and final parameters as well as
to the JAX test's convergence bound.  Here: GN, the three strategies,
the rejected step, the reject budget and the non-finite guard, the
quality guard.

Tolerances.  Per-step loss within 1e-4 relative plus 1e-9 absolute in
float32 (the losses fall from ~1 to float32's rounding floor, ~1e-14,
where only the absolute term means anything) and 1e-8 relative plus
1e-20 in float64; parameters within 1e-5 (float32) and 1e-10 (float64).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu as jpp
from pypose_tpu.optim import strategy as jstrat
import pypose_tpu_torch as pp
from pypose_tpu_torch.optim import strategy as tstrat
from pypose_tpu_torch.testing import cap_threads

cap_threads()

LOSS_TOL = {'float32': (1e-4, 1e-9), 'float64': (1e-8, 1e-20)}
PARAM_TOL = {'float32': 1e-5, 'float64': 1e-10}


def draw(shape, seed, dtype='float32', sigma=0.5):
    """The JAX test's PoseInv start and inputs, as numpy."""
    with jax.enable_x64(dtype == 'float64'):
        dt = getattr(jnp, dtype)
        pose = jpp.randn_se3(*shape, sigma=sigma, key=jax.random.PRNGKey(seed),
                             dtype=dt)
        inp = jpp.randn_SE3(*shape, key=jax.random.PRNGKey(seed + 100),
                            dtype=dt)
        return np.array(pose.tensor()), np.array(inp.tensor())


class JPoseInv(jpp.Module):
    def __init__(self, pose):
        super().__init__()
        self.pose = jpp.Parameter(jpp.se3(jnp.asarray(pose)))

    def forward(self, input):
        return (self.pose.Exp() @ input).Log().tensor()


class TPoseInv(pp.Module):
    def __init__(self, pose):
        super().__init__()
        self.pose = pp.Parameter(pp.se3(torch.tensor(pose)))

    def forward(self, input):
        return (self.pose.Exp() @ input).Log().tensor()


def run(make_j, make_t, pose, inp, steps, dtype='float32', step_kw=None):
    """``steps`` step() calls of each package's optimizer; returns the
    losses, the reject counts and the final poses."""
    step_kw = step_kw or {}
    with jax.enable_x64(dtype == 'float64'):
        jm = JPoseInv(pose)
        jo = make_j(jm)
        jx = jpp.SE3(jnp.asarray(inp))
        jl, jr = [], []
        for _ in range(steps):
            jl.append(jo.step(jx, **step_kw.get('jax', {})))
            jr.append(getattr(jo, 'reject_count', 0))
        jpose = np.array(jm.pose.tensor())
    tm = TPoseInv(pose)
    to = make_t(tm)
    tx = pp.SE3(torch.from_numpy(inp))
    tl, tr = [], []
    for _ in range(steps):
        tl.append(to.step(tx, **step_kw.get('torch', {})))
        tr.append(getattr(to, 'reject_count', 0))
    return jl, tl, jr, tr, jpose, tm.pose.tensor().detach().numpy()


def assert_run(res, dtype, bound):
    """Losses, parameters and the bound; rejections only for the steps
    that start above 1e-9: at float32's rounding floor whether a step
    raises the loss is rounding noise, in either package."""
    jl, tl, jr, tr, jpose, tpose = res
    rtol, atol = LOSS_TOL[dtype]
    np.testing.assert_allclose(tl, jl, rtol=rtol, atol=atol)
    live = [i for i in range(len(jl)) if i == 0 or jl[i - 1] > 1e-9]
    assert [tr[i] for i in live] == [jr[i] for i in live]
    np.testing.assert_allclose(tpose, jpose, atol=PARAM_TOL[dtype])
    assert tl[-1] < bound


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_gn_converges(dtype):
    pose, inp = draw((2, 2), 0, dtype)
    assert_run(run(lambda m: jpp.optim.GN(m), lambda m: pp.optim.GN(m),
                   pose, inp, 5, dtype), dtype, 1e-8)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('name', ['Constant', 'Adaptive', 'TrustRegion'])
def test_lm_strategies_converge(name, dtype):
    kw = {'Constant': dict(damping=1e-6), 'Adaptive': dict(damping=1e-6),
          'TrustRegion': dict(radius=1e4)}[name]
    pose, inp = draw((2, 2), 1, dtype)
    assert_run(run(
        lambda m: jpp.optim.LM(m, strategy=getattr(jstrat, name)(**kw)),
        lambda m: pp.optim.LM(m, strategy=getattr(tstrat, name)(**kw)),
        pose, inp, 8, dtype), dtype, 1e-8)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_lm_rejects_bad_step(dtype):
    """Constant(1e2): the loss never rises; rejections and losses as the
    JAX package's."""
    pose, inp = draw((2, 2), 7, dtype)
    res = run(lambda m: jpp.optim.LM(m, strategy=jstrat.Constant(1e2)),
              lambda m: pp.optim.LM(m, strategy=tstrat.Constant(1e2)),
              pose, inp, 5, dtype)
    tl = res[1]
    assert all(b <= a + 1e-9 for a, b in zip(tl, tl[1:]))
    assert_run(res, dtype, np.inf)


def test_lm_reject_budget_and_nonfinite_guard():
    """A model whose every step raises the loss: 'reject' rejections,
    then the last candidate is taken, as in the JAX package; a step whose
    candidate loss is not finite is never taken."""
    pose, inp = draw((2, 2), 11)
    res = run(lambda m: jpp.optim.LM(m, strategy=jstrat.Constant(1e-6),
                                     reject=3, max=1e-9),
              lambda m: pp.optim.LM(m, strategy=tstrat.Constant(1e-6),
                                    reject=3, max=1e-9),
              pose, inp, 2)
    assert_run(res, 'float32', np.inf)

    class NaNAbove(pp.Module):
        def __init__(self):
            super().__init__()
            self.x = pp.Parameter(torch.tensor([3.0]))

        def forward(self, input):
            return torch.where(self.x > 1.0, self.x - input,
                               torch.full_like(self.x, float('nan')))
    m = NaNAbove()
    o = pp.optim.LM(m, strategy=tstrat.Constant(1e-6), reject=2)
    loss = o.step(torch.tensor([0.0]))
    assert loss == 9.0 and float(m.x) == 3.0 and o.reject_count == 0


def test_quality_guard_on_nondescent_prediction():
    J = torch.eye(2)
    R = torch.ones(2, 1)
    D_descent = -torch.ones(2, 1) * 0.5
    D_garbage = torch.ones(2, 1) * 10.0
    q_good = tstrat._quality(torch.tensor(2.0), torch.tensor(0.5), J,
                             D_descent, R)
    assert float(q_good) > 0
    q_trap = tstrat._quality(torch.tensor(2.0), torch.tensor(200.0), J,
                             D_garbage, R)
    assert float(q_trap) == -1.0
    ts = tstrat.TrustRegion(radius=1e6)
    st = ts.init()
    st2 = ts.update(st, torch.tensor(2.0), torch.tensor(200.0), J,
                    D_garbage, R)
    jt = jstrat.TrustRegion(radius=1e6)
    jst2 = jt.update(jt.init(), jnp.asarray(2.0), jnp.asarray(200.0),
                     jnp.eye(2), jnp.ones((2, 1)) * 10.0, jnp.ones((2, 1)))
    assert float(st2['damping']) > float(st['damping'])
    np.testing.assert_allclose(float(st2['damping']),
                               float(jst2['damping']), rtol=1e-7)
    np.testing.assert_allclose(float(st2['down']), float(jst2['down']))
