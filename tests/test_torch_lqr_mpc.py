"""``module/lqr.py`` and ``module/mpc.py`` of the port against the JAX
package on the same arrays, in float32 and float64, and the MPC cells'
JAX anchor.

- LQR on a random LTI system (tests/module/test_lqr_mpc.py's) and on the
  cart-pole (an NLS, linearized by jacrev at each step): (K, k) of the
  backward pass, the rollout and its cost, also with ``mu`` and
  ``robust``; ``_sq`` squeezes only a batch of one, in both packages.
- MPC: vanilla iLQR on the cart-pole at T = 32 (``bench.py:
  bench_modules``' [mpc] schedule, ReduceToBason(steps=5)), the robust
  iLQR (``line_search=True``) at T = 24, the verbose host loop, and the
  gradient of the final pass's cost with respect to the initial state
  against ``jax.grad`` (T = 8).
- The anchor (``data/jax_anchor_mpc.json``): the JAX package's [mpc]
  (T = 32) and [mpc-ls] (T = 128, line search, ReduceToBason(steps=30))
  cells in float32: cost, the pole angle's tail max|theta| over the back
  half and the trajectories; the port's CPU run is held to the cost and
  the tail (the T = 128 plant is chaotic: trajectories are not compared,
  ``pypose_tpu/module/lqr.py:119-133``).  Write it (~1 min) with
  ``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_lqr_mpc.py``.

Tolerances: LQR 1e-5 (float32) and 1e-11 (float64) of (1 + magnitude);
MPC at T = 32 and T = 24 2e-4 (float32: measured 2.3e-5 in the states
at T = 32) and 1e-9 (float64); the gradient 1e-4 and 1e-9 relative.  At
the anchor: cost within 1e-4 relative (measured 5.3e-6 at T = 32 and
1e-7 at T = 128 on the CPU), the tail within 1e-3 absolute, and below
0.1 at T = 128 (the JAX test's swing-up bound).
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pypose_tpu.module import LQR as JLQR, LTI as JLTI, MPC as JMPC
from pypose_tpu.module import NLS as JNLS
from pypose_tpu.module import lqr as jlqr_mod
from pypose_tpu.utils import ReduceToBason as JReduceToBason
from pypose_tpu_torch.datasets import find_data
from pypose_tpu_torch.module import LQR, LTI, MPC
from pypose_tpu_torch.module import lqr as lqr_mod
from pypose_tpu_torch.module import mpc as mpc_mod
from pypose_tpu_torch.testing import (MPC_CELLS as CELLS, cartpole,
                                      cartpole_problem, mpc_cell,
                                      mpc_failures, mpc_tail)
from pypose_tpu_torch.utils import ReduceToBason
from pypose_tpu_torch.testing import cap_threads

cap_threads()

DTYPES = ['float32', 'float64']
LQR_TOL = {'float32': 1e-5, 'float64': 1e-11}
MPC_TOL = {'float32': 2e-4, 'float64': 1e-9}
ANCHOR = 'jax_anchor_mpc.json'


class JCartPole(JNLS):
    """bench.py:bench_modules' cart-pole (testing.cartpole's)."""

    def state_transition(self, state, input, t=None):
        x, dx, th, dth = (state[..., 0], state[..., 1],
                          state[..., 2], state[..., 3])
        f = input[..., 0]
        dtt, g, mc, mp, l = 0.05, 9.81, 1.0, 0.1, 0.5
        tmp = (f + mp * l * dth ** 2 * jnp.sin(th)) / (mc + mp)
        thacc = (g * jnp.sin(th) - jnp.cos(th) * tmp) / \
            (l * (4.0 / 3 - mp * jnp.cos(th) ** 2 / (mc + mp)))
        xacc = tmp - mp * l * thacc * jnp.cos(th) / (mc + mp)
        return jnp.stack([x + dtt * dx, dx + dtt * xacc,
                          th + dtt * dth, dth + dtt * thacc], axis=-1)

    def observation(self, state, input, t=None):
        return state


def close(got, want, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * (1 + np.abs(want).max()))


def lti_problem(dtype):
    """tests/module/test_lqr_mpc.py:test_lqr_matches_numpy_riccati's."""
    rng = np.random.default_rng(0)
    ns, nc = 3, 2
    A = np.eye(ns) + 0.1 * rng.normal(size=(ns, ns))
    B = rng.normal(size=(ns, nc))
    Qm = rng.normal(size=(ns + nc, ns + nc))
    Qm = Qm @ Qm.T + (ns + nc) * np.eye(ns + nc)
    p = rng.normal(size=(ns + nc,))
    x0 = rng.normal(size=(ns,))
    mats = [A, B, np.eye(ns), np.zeros((ns, nc))]
    return ([m.astype(dtype) for m in mats], Qm.astype(dtype)[None],
            p.astype(dtype)[None], x0.astype(dtype)[None])


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('plant', ['lti', 'cartpole'])
def test_lqr_matches_jax(plant, dtype):
    """(K, k), the rollout and its cost: T = 5 on the LTI system, T = 16 on
    the cart-pole from a nonzero input trajectory, and the cart-pole again
    with mu = 1e-3 and robust saturation."""
    tdt = getattr(torch, dtype)
    if plant == 'lti':
        mats, Q, p, x0 = lti_problem(dtype)
        T, u0 = 5, None
        make_t = lambda: LTI(*(torch.from_numpy(m) for m in mats))  # noqa
        make_j = lambda: JLTI(*(jnp.asarray(m) for m in mats))  # noqa
        runs = [dict()]
    else:
        Qt, pt, xt = cartpole_problem(device='cpu', dtype=tdt)
        Q, p, x0 = Qt.numpy(), pt.numpy(), xt.numpy()
        T = 16
        u0 = (0.3 * np.random.default_rng(1).normal(size=(1, T, 1))
              ).astype(dtype)
        make_t, make_j = cartpole, JCartPole
        runs = [dict(), dict(mu=1e-3, robust=True)]
    for kw in runs:
        tl = LQR(make_t(), torch.from_numpy(Q), torch.from_numpy(p), T)
        targs = dict(u_traj=None if u0 is None else torch.from_numpy(u0),
                     **kw)
        K, k = tl.lqr_backward(torch.from_numpy(x0), 0.05, **targs)
        x, u, cost = tl.lqr_forward(torch.from_numpy(x0), K, k,
                                    robust=kw.get('robust', False))
        with jax.enable_x64(dtype == 'float64'):
            jl = JLQR(make_j(), jnp.asarray(Q), jnp.asarray(p), T)
            jargs = dict(u_traj=None if u0 is None else jnp.asarray(u0),
                         **kw)
            jK, jk = jl.lqr_backward(jnp.asarray(x0), 0.05, **jargs)
            jx, ju, jc = jl.lqr_forward(jnp.asarray(x0), jK, jk,
                                        robust=kw.get('robust', False))
            for got, want in ((K, jK), (k, jk), (x, jx), (u, ju),
                              (cost, jc)):
                close(got, want, LQR_TOL[dtype])


def test_sq_squeezes_only_a_batch_of_one():
    """``_sq`` (pypose_tpu/module/lqr.py:255-260) squeezes dim -2 of a
    batched jacrev only when the batch is one: a batch of two keeps the
    (2, n, 2, n) Jacobian, in both packages."""
    for shape in ((1, 4, 1, 4), (2, 4, 2, 4), (4, 4)):
        a = np.zeros(shape, np.float32)
        assert tuple(lqr_mod._sq(torch.from_numpy(a)).shape) == \
            jlqr_mod._sq(jnp.asarray(a)).shape


def mpc_pair(T, steps, line_search, dtype, verbose=False):
    tdt = getattr(torch, dtype)
    Q, p, x0 = cartpole_problem(device='cpu', dtype=tdt)
    t = MPC(cartpole(), Q, p, T,
            stepper=ReduceToBason(steps=steps, verbose=verbose),
            line_search=line_search)
    j = JMPC(JCartPole(), jnp.asarray(Q.numpy()), jnp.asarray(p.numpy()), T,
             stepper=JReduceToBason(steps=steps, verbose=verbose),
             line_search=line_search)
    return t, j, x0


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', ['vanilla-T32', 'line-search-T24',
                                  'verbose-T16'])
def test_mpc_matches_jax(case, dtype):
    """The final pass's (x, u, cost) after the iLQR loop; the host reads
    (one an iteration but the last)."""
    T, steps, ls, verbose = {'vanilla-T32': (32, 5, False, False),
                             'line-search-T24': (24, 8, True, False),
                             'verbose-T16': (16, 3, False, True)}[case]
    with jax.enable_x64(dtype == 'float64'):
        t, j, x0 = mpc_pair(T, steps, ls, dtype, verbose=verbose)
        reads = mpc_mod.HOST_READS
        x, u, cost = t(0.05, x0)
        jx, ju, jc = j(0.05, jnp.asarray(x0.numpy()))
        for got, want in ((x, jx), (u, ju), (cost, jc)):
            close(got, want, MPC_TOL[dtype])
    if not verbose:
        assert 0 < mpc_mod.HOST_READS - reads < t.stepper.max_steps
    assert tuple(x.shape) == (1, T + 1, 4) and tuple(u.shape) == (1, T, 1)


@pytest.mark.parametrize('dtype', DTYPES)
def test_mpc_final_pass_gradient_matches_jax(dtype):
    """d(cost)/d(x_init) through the final differentiable pass (the loop
    runs without gradients in both packages), T = 8."""
    with jax.enable_x64(dtype == 'float64'):
        t, j, x0 = mpc_pair(8, 3, False, dtype)
        x0 = x0.clone().requires_grad_()
        t(0.05, x0)[2].sum().backward()
        jg = jax.grad(lambda a: j(0.05, a)[2].sum())(
            jnp.asarray(x0.detach().numpy()))
        tol = 1e-4 if dtype == 'float32' else 1e-9
        np.testing.assert_allclose(x0.grad.numpy(), np.asarray(jg),
                                   rtol=tol, atol=tol)
        assert np.abs(np.asarray(jg)).max() > 0


@pytest.mark.parametrize('name', list(CELLS))
def test_cells_hold_the_jax_anchor(name):
    """[mpc] and [mpc-ls] at full size on the CPU against
    data/jax_anchor_mpc.json."""
    with open(find_data(ANCHOR)) as f:
        anchor = json.load(f)
    x, u, cost = mpc_cell(name, 'cpu')
    assert not mpc_failures(name, anchor[name], x, cost)
    assert bool(torch.isfinite(x).all()) and bool(torch.isfinite(u).all())


if __name__ == '__main__':
    import time
    from _anchor import write_anchor
    out, gaps = {}, {}
    for name, (T, steps, ls) in CELLS.items():
        Q, p, x0 = cartpole_problem(device='cpu')
        t0 = time.perf_counter()
        jm = JMPC(JCartPole(), jnp.asarray(Q.numpy()), jnp.asarray(p.numpy()),
                  T, stepper=JReduceToBason(steps=steps), line_search=ls)
        jx, ju, jc = jm(0.05, jnp.asarray(x0.numpy()))
        jax_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        reads = mpc_mod.HOST_READS
        x, u, cost = mpc_cell(name, 'cpu')
        port_s = time.perf_counter() - t0
        out[name] = {'T': T, 'steps': steps, 'line_search': ls,
                     'cost': float(jc[0]), 'tail': mpc_tail(jx),
                     'x': np.asarray(jx, np.float64)[0].tolist(),
                     'u': np.asarray(ju, np.float64)[0].tolist(),
                     'seconds': {'jax': round(jax_s, 1),
                                 'port_cpu': round(port_s, 1)}}
        gaps[name] = {'cost': float(cost[0]), 'tail': mpc_tail(x),
                      'host_reads': mpc_mod.HOST_READS - reads,
                      'failures': mpc_failures(name, out[name], x, cost)}
        print(name, out[name]['cost'], out[name]['tail'], gaps[name],
              flush=True)
    write_anchor('mpc', 'tests/test_torch_lqr_mpc.py', {
        'problem': 'bench.py:bench_modules: the cart-pole from (0, 0, 0.3, '
                   '0), Q = diag(1, 0.1, 10, 0.1, 0.01), p = 0, dt 0.05, '
                   'float32; [mpc] T = 32 ReduceToBason(steps=5), [mpc-ls] '
                   'T = 128 line_search ReduceToBason(steps=30)',
        'port_cpu': gaps,
        'tolerance': 'cost within 1e-4 relative, tail max|theta| over the '
                     'back half within 1e-3 (and below 0.1 for mpc-ls)',
        **out})
