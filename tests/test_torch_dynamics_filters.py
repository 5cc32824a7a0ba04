"""``module/dynamics.py``, the EKF, UKF and PF and ``filter_rollout`` of
the port against the JAX package on the same numpy-drawn arrays, in
float32 and float64, and the filter cells' JAX anchor.

- NLS Jacobians (``A``, ``B``, ``C``, ``D``, the affine remainders) at an
  unbatched and a batched (3, 2) reference point, where a batched state
  gives the JAX package's ``(*B, n, *B, n)`` (and the remainders raise in
  both packages); LTI, an LTV whose ``A``
  flips sign with the system time, ``runsys`` and ``toBTN``.
- One EKF and UKF step unbatched and under ``torch.func.vmap`` (the JAX
  tests' ``jax.vmap``), one PF step unbatched and batched (B = 3), and
  50-step rollouts of all three.  The PF's draws are JAX's own
  (``jax.random.normal`` for ``multivariate_normal``'s Cholesky method,
  ``jax.random.uniform`` for the resampling), injected through
  ``PF.draw``, so both packages resample the same particles.
- The anchor (``data/jax_anchor_filters.json``): ``bench.py:
  bench_filters``' pendulum over ``testing.filter_instance(1000)``, the
  JAX package's EKF and UKF estimates at every 100th step and final
  covariance, and the PF's error statistics (its draws are jax.random's);
  the port's CPU run is held to them.  Write it (~1 min) with
  ``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_dynamics_filters.py``.

Tolerances: one step 2e-6 (float32) and 1e-12 (float64) of (1 + the
value's magnitude); rollouts over 50 steps 2e-5 and 1e-11 (measured on
the CPU: 1.2e-6 at worst over 1,000 float32 UKF steps); the PF's
resampled particles are the same rows, so its steps hold the same
bounds.  At the anchor: EKF and UKF estimates within 2e-5 (1 + |x|); the
PF's RMSE against the true state within 1% of the JAX package's
(``testing.PF_RMSE_RTOL``; its draws differ: measured 0.141408 against
0.141409, and over 10 seeds a standard deviation of 1.5e-3 of it).
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pypose_tpu.module import (EKF as JEKF, LTI as JLTI, LTV as JLTV,
                               NLS as JNLS, PF as JPF, UKF as JUKF,
                               filter_rollout as jrollout)
from pypose_tpu.module.dynamics import runsys as jrunsys, toBTN as jtoBTN
from pypose_tpu_torch.datasets import find_data
from pypose_tpu_torch.module import (EKF, LTI, LTV, NLS, PF, UKF,
                                     filter_rollout)
from pypose_tpu_torch.module.dynamics import runsys, toBTN
from pypose_tpu_torch.testing import (FILTER_T, PF_PARTICLES,
                                      PF_RMSE_RTOL, filter_failures,
                                      filter_instance, filter_rmse,
                                      filter_rollouts, filter_summary,
                                      pendulum, pf_draws)
from pypose_tpu_torch.testing import cap_threads

cap_threads()

DTYPES = ['float32', 'float64']
STEP_TOL = {'float32': 2e-6, 'float64': 1e-12}
ROLL_TOL = {'float32': 2e-5, 'float64': 1e-11}
ANCHOR = 'jax_anchor_filters.json'


class Sys(NLS):
    """tests/module/test_filters.py's system."""

    def state_transition(self, state, input, t=None):
        return torch.cos(state) + input

    def observation(self, state, input, t=None):
        return torch.sin(state) + input


class JSys(JNLS):
    def state_transition(self, state, input, t=None):
        return jnp.cos(state) + input

    def observation(self, state, input, t=None):
        return jnp.sin(state) + input


class JPendulum(JNLS):
    """bench.py:bench_filters' pendulum (testing.pendulum's)."""

    def state_transition(self, state, input, t=None):
        th, om = state[..., 0], state[..., 1]
        om = om + 0.05 * (-9.81 * jnp.sin(th) + input[..., 0])
        return jnp.stack([th + 0.05 * om, om], axis=-1)

    def observation(self, state, input, t=None):
        return state


def close(got, want, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * (1 + np.abs(want).max()))


def draws(dtype, *shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(dtype) for s in shapes]


@pytest.mark.parametrize('dtype', DTYPES)
def test_nls_jacobians_match_jax(dtype):
    """A..D, c1 and c2 at an unbatched and a batched reference point."""
    for shape in ((2,), (3, 2)):
        x, u = draws(dtype, shape, shape)
        t_sys = Sys()
        t_sys.set_refpoint(state=torch.from_numpy(x),
                           input=torch.from_numpy(u))
        with jax.enable_x64(dtype == 'float64'):
            j_sys = JSys()
            j_sys.set_refpoint(state=jnp.asarray(x), input=jnp.asarray(u))
            for name in ('A', 'B', 'C', 'D', 'c1', 'c2'):
                if len(shape) == 1:
                    close(getattr(t_sys, name), getattr(j_sys, name),
                          STEP_TOL[dtype])
                    continue
                if name in ('c1', 'c2'):
                    # bmv of a (*B, n, *B, n) Jacobian: both packages raise
                    with pytest.raises(ValueError):
                        getattr(j_sys, name)
                    with pytest.raises(RuntimeError):
                        getattr(t_sys, name)
                    continue
                close(getattr(t_sys, name), getattr(j_sys, name),
                      STEP_TOL[dtype])
        assert tuple(t_sys.A.shape) == shape + shape


class Periodic(LTV):
    def __init__(self, dtype):
        super().__init__(torch.eye(2, dtype=dtype),
                         torch.ones(2, 1, dtype=dtype),
                         torch.eye(2, dtype=dtype),
                         torch.zeros(2, 1, dtype=dtype))

    @property
    def A(self):
        return (1.0 - 2.0 * (self.systime % 2)) * self._A


class JPeriodic(JLTV):
    def __init__(self):
        super().__init__(jnp.eye(2), jnp.ones((2, 1)), jnp.eye(2),
                         jnp.zeros((2, 1)))

    @property
    def A(self):
        return (1.0 - 2.0 * (self.systime % 2)) * self._A


@pytest.mark.parametrize('dtype', DTYPES)
def test_lti_ltv_runsys_match_jax(dtype):
    """LTI's forward and time, the LTV's time-varying A, runsys, toBTN."""
    tdt = getattr(torch, dtype)
    A, B, x, u = draws(dtype, (3, 3), (3, 2), (3,), (4, 2))
    C, D = np.eye(3, dtype=dtype), np.zeros((3, 2), dtype)
    t_lti = LTI(*(torch.from_numpy(m) for m in (0.5 * A, B, C, D)))
    with jax.enable_x64(dtype == 'float64'):
        j_lti = JLTI(*(jnp.asarray(m) for m in (0.5 * A, B, C, D)))
        for sys_t, sys_j in ((t_lti, j_lti), (Periodic(tdt), JPeriodic())):
            xt, xj = torch.from_numpy(x[:sys_t.B.shape[0]]), \
                jnp.asarray(x[:sys_t.B.shape[0]])
            for i in range(3):
                ui = u[i, :sys_t.B.shape[1]]
                xt, yt = sys_t(xt, torch.from_numpy(ui))
                xj, yj = sys_j(xj, jnp.asarray(ui))
                close(xt, xj, STEP_TOL[dtype])
                close(yt, yj, STEP_TOL[dtype])
            assert int(sys_t.systime) == int(sys_j.systime) == 3
        traj_t = runsys(LTI(*(torch.from_numpy(m)
                              for m in (0.5 * A, B, C, D))), 4,
                        torch.from_numpy(x)[None, None],
                        torch.from_numpy(u)[None])
        traj_j = jrunsys(JLTI(*(jnp.asarray(m) for m in (0.5 * A, B, C, D))),
                         4, jnp.asarray(x)[None, None], jnp.asarray(u)[None])
        close(traj_t, traj_j, STEP_TOL[dtype])
        assert tuple(toBTN(torch.ones(2), 3).shape) == \
            jtoBTN(jnp.ones(2), 3).shape == (1, 3, 2)


def step_inputs(dtype, batch=()):
    x, y, u = draws(dtype, batch + (2,), batch + (2,), batch + (2,), seed=1)
    P = np.broadcast_to(np.eye(2, dtype=dtype) * 0.5, batch + (2, 2)).copy()
    Q, R = (np.eye(2, dtype=dtype) * 0.01 for _ in range(2))
    return x, y, u, P, Q, R


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('kind', ['ekf', 'ukf'])
def test_kalman_step_matches_jax(kind, dtype):
    """One step unbatched, and a batch of 3 under vmap."""
    make_t, make_j = {'ekf': (EKF, JEKF), 'ukf': (UKF, JUKF)}[kind]
    for batch in ((), (3,)):
        x, y, u, P, Q, R = step_inputs(dtype, batch)
        tf = make_t(Sys(), torch.from_numpy(Q), torch.from_numpy(R))
        targs = [torch.from_numpy(a) for a in (x, y, u, P)]
        with jax.enable_x64(dtype == 'float64'):
            jf = make_j(JSys(), jnp.asarray(Q), jnp.asarray(R))
            jargs = [jnp.asarray(a) for a in (x, y, u, P)]
            if batch:
                xt, Pt = torch.func.vmap(tf)(*targs)
                xj, Pj = jax.vmap(jf)(*jargs)
            else:
                xt, Pt = tf(*targs)
                xj, Pj = jf(*jargs)
            close(xt, xj, STEP_TOL[dtype])
            close(Pt, Pj, STEP_TOL[dtype])


class InjectedPF(PF):
    """The port's PF drawing given arrays in order: the JAX package's own
    draws from the same key."""

    def __init__(self, *args, queue, **kw):
        super().__init__(*args, **kw)
        self.queue = list(queue)

    def draw(self, kind, shape, like, generator):
        got = self.queue.pop(0)
        assert got[0] == kind and tuple(got[1].shape) == tuple(shape)
        return torch.from_numpy(np.array(got[1])).to(like)


def jax_pf_draws(key, particles, x_shape, dtype):
    """The normal and uniform draws PF.forward makes from ``key``
    (pypose_tpu/module/pf.py:41, 60-66, 75): (kind, array) in order."""
    k1, k2 = jax.random.split(key)
    jdt = jnp.float64 if dtype == 'float64' else jnp.float32
    z = jax.random.normal(k1, (particles,) + tuple(x_shape), jdt)
    r = jax.random.uniform(k2, tuple(x_shape[:-1]) + (particles,), jdt)
    return [('normal', np.asarray(z)), ('uniform', np.asarray(r))]


@pytest.mark.parametrize('dtype', DTYPES)
def test_pf_step_matches_jax_with_its_draws(dtype):
    """One PF step of 300 particles, unbatched and batched (B = 3: the
    batched searchsorted), on the JAX package's draws."""
    for batch in ((), (3,)):
        x, y, u, P, Q, R = step_inputs(dtype, batch)
        with jax.enable_x64(dtype == 'float64'):
            key = jax.random.PRNGKey(41)
            jf = JPF(JSys(), jnp.asarray(Q), jnp.asarray(R), particles=300)
            xj, Pj = jf(*(jnp.asarray(a) for a in (x, y, u, P)), key=key)
            queue = jax_pf_draws(key, 300, x.shape, dtype)
        tf = InjectedPF(Sys(), torch.from_numpy(Q), torch.from_numpy(R),
                        particles=300, queue=queue)
        xt, Pt = tf(*(torch.from_numpy(a) for a in (x, y, u, P)))
        assert not tf.queue
        close(xt, xj, STEP_TOL[dtype])
        close(Pt, Pj, STEP_TOL[dtype])


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('kind', ['ekf', 'ukf', 'pf'])
def test_rollout_matches_jax(kind, dtype):
    """50 steps of the pendulum (testing.filter_instance) through
    filter_rollout; the PF on the JAX package's per-step draws."""
    tdt = getattr(torch, dtype)
    d = filter_instance(50, seed=3, device='cpu', dtype=tdt)
    nd = {k: v.numpy() for k, v in d.items()}
    with jax.enable_x64(dtype == 'float64'):
        J = {k: jnp.asarray(v) for k, v in nd.items()}
        key = jax.random.PRNGKey(30)
        jf = {'ekf': lambda: JEKF(JPendulum(), J['Q'], J['R']),
              'ukf': lambda: JUKF(JPendulum(), J['Q'], J['R']),
              'pf': lambda: JPF(JPendulum(), J['Q'], J['R'],
                                particles=200)}[kind]()
        xj, Pj = jrollout(jf, J['x0'], J['P0'], J['ys'], J['us'], key=key)
        queue = [q for k in jax.random.split(key, 50)
                 for q in jax_pf_draws(k, 200, (2,), dtype)]
    tf = {'ekf': lambda: EKF(pendulum(), d['Q'], d['R']),
          'ukf': lambda: UKF(pendulum(), d['Q'], d['R']),
          'pf': lambda: InjectedPF(pendulum(), d['Q'], d['R'],
                                   particles=200, queue=queue)}[kind]()
    xt, Pt = filter_rollout(tf, d['x0'], d['P0'], d['ys'], d['us'])
    assert tuple(xt.shape) == (50, 2) and tuple(Pt.shape) == (50, 2, 2)
    close(xt, xj, ROLL_TOL[dtype])
    close(Pt, Pj, ROLL_TOL[dtype])


@pytest.mark.parametrize('dtype', DTYPES)
def test_filter_rollouts_feeds_given_draws(dtype):
    """testing.filter_rollouts(draws=) (how the card's PF is held to the
    CPU's on the same numbers) gives step t the normals and uniforms of
    row t, as InjectedPF, which the JAX package holds above, does."""
    tdt = getattr(torch, dtype)
    d = filter_instance(20, seed=3, device='cpu', dtype=tdt)
    z, r = pf_draws(20, PF_PARTICLES, 2, tdt, seed=5)
    xs, Ps = filter_rollouts('cpu', kinds=('pf',), d=d, draws=(z, r))[0]['pf']
    queue = [q for t in range(20)
             for q in (('normal', z[t].numpy()), ('uniform', r[t].numpy()))]
    tf = InjectedPF(pendulum(), d['Q'], d['R'], particles=PF_PARTICLES,
                    queue=queue)
    xt, Pt = filter_rollout(tf, d['x0'], d['P0'], d['ys'], d['us'])
    assert not tf.queue
    assert torch.equal(xs, xt) and torch.equal(Ps, Pt)
    other = filter_rollouts('cpu', kinds=('pf',), d=d)[0]['pf'][0]
    assert not torch.equal(xs, other)


def test_rollouts_hold_the_jax_anchor():
    """The three filter cells at full size on the CPU against
    data/jax_anchor_filters.json."""
    with open(find_data(ANCHOR)) as f:
        anchor = json.load(f)
    out, d = filter_rollouts('cpu')
    assert anchor['instance_checksum'] == pytest.approx(
        float(d['ys'].double().abs().sum()), rel=1e-12)
    bad, gaps = filter_failures(anchor, d['truth'], out)
    assert not bad, (bad, gaps)
    for kind in ('ekf', 'ukf'):
        assert filter_rmse(out[kind][0], d['truth']) == pytest.approx(
            anchor[kind]['rmse'], rel=1e-3)


def _jax_anchor():
    d = filter_instance(FILTER_T, device='cpu')
    J = {k: jnp.asarray(v.numpy()) for k, v in d.items()}
    out = {}
    for kind, make in (('ekf', lambda: JEKF(JPendulum(), J['Q'], J['R'])),
                       ('ukf', lambda: JUKF(JPendulum(), J['Q'], J['R'])),
                       ('pf', lambda: JPF(JPendulum(), J['Q'], J['R'],
                                          particles=PF_PARTICLES))):
        filt = make()
        out[kind] = jax.jit(lambda x0, P0, ys, us, k: jrollout(
            filt, x0, P0, ys, us, key=k))(J['x0'], J['P0'], J['ys'],
                                          J['us'], jax.random.PRNGKey(3))
    return d, filter_summary(out, d['truth'])


if __name__ == '__main__':
    import time
    from _anchor import write_anchor
    t0 = time.perf_counter()
    d, jout = _jax_anchor()
    jax_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tout, _ = filter_rollouts('cpu')
    port_s = time.perf_counter() - t0
    bad, gaps = filter_failures(jout, d['truth'], tout)
    print(f'JAX {jax_s:.1f} s, port CPU {port_s:.1f} s; port against JAX: '
          f'{gaps}; outside: {bad}', flush=True)
    write_anchor('filters', 'tests/test_torch_dynamics_filters.py', {
        'problem': f'bench.py:bench_filters: the pendulum, N = 2, Q = 1e-4 '
                   f'I, R = 1e-2 I, x0 = 0, P0 = I, over testing.'
                   f'filter_instance({FILTER_T}) (seed 0), float32; PF of '
                   f'{PF_PARTICLES} particles (jax.random.PRNGKey(3))',
        'instance_checksum': float(d['ys'].double().abs().sum()),
        'port_cpu_gaps': gaps,
        'tolerance': 'EKF/UKF estimates at every 100th step and the final '
                     'covariance within 2e-5 (1 + magnitude); PF RMSE '
                     f'within {PF_RMSE_RTOL:.0%} of the JAX package\'s',
        'seconds': {'jax': round(jax_s, 1), 'port_cpu': round(port_s, 1)},
        **jout})
