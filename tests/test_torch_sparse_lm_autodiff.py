"""SparseLM with autodiff Jacobians and robust kernels, against the
closed forms and against the JAX package on identical arrays (CPU).

- The autodiff blocks (``torch.func.vjp`` of the residual at
  ``Retr(eps)``, eps = 0, and a ``vmap`` of its pullback) equal
  ``pgo_factor``'s closed forms over SO3, SE3, RxSO3 and Sim3: within
  1e-5 (1 + max|J|) in float32 and 1e-11 in float64 (measured: 2.9e-6 and
  1.1e-14 at worst, Sim3).
- ``tests/optim/test_sparse_lm.py``'s ``test_sim3_chain_jacrev_fallback``,
  ``test_mixed_groups_ba_style`` and ``test_pgo_with_infos_and_kernel``,
  mirrored with numpy draws that both packages take bit for bit: each
  chi2 history is held to the JAX package's (entries above 1e-6 of the
  first within ``HIST_RTOL``; both end below the JAX test's bounds).
- ``pgo_factor(..., kernel=...)`` takes the JAX package's argument.

The full-size runs with autodiff Jacobians and robust kernels are held to
their JAX anchors in ``test_torch_sphere2500_huber_anchor.py`` and
``test_torch_reproj_pgo_anchor.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu as jpp
from pypose_tpu.optim import kernel as jkernel
from pypose_tpu.optim import sparse as jsparse
import pypose_tpu_torch as ppt
from pypose_tpu_torch.datasets import find_data, load_g2o
from pypose_tpu_torch.optim.kernel import Huber
from pypose_tpu_torch.optim.sparse import (Factor, SparseLM, pgo_factor,
                                           split_chain_edges)
from pypose_tpu_torch.optim.strategy import TrustRegion
from pypose_tpu_torch.testing import (
    pgo_group_instance, pgo_loops_instance, pgo_optimizer, residual_only)

HIST_RTOL = 1e-3
BLOCK_TOL = {torch.float32: 1e-5, torch.float64: 1e-11}
HUBER_DELTA = 5.0


def group_graph(group, dtype):
    """A 200-node ring with random loops over ``group`` (RxSO3: the SE3
    graph's rotations with a drifted scale)."""
    if group == 'RxSO3':
        return pgo_group_instance(
            pgo_loops_instance(200, dtype=dtype, device='cpu'), 'RxSO3',
            torch.Generator().manual_seed(7))
    return pgo_loops_instance(200, dtype=dtype, device='cpu', group=group)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('group', ['SO3', 'SE3', 'RxSO3', 'Sim3'])
def test_autodiff_blocks_match_closed_form(group, dtype):
    ds = group_graph(group, dtype)
    closed = pgo_factor(ds['edges'], ds['poses'])
    auto = residual_only(closed)
    assert closed.batched_jacobian is not None
    assert auto.batched_jacobian is None
    opt = SparseLM({'poses': ds['nodes']}, [closed, auto])
    r1, J1 = opt._edge_r_jac(opt.params, closed, 0)
    r2, J2 = opt._edge_r_jac(opt.params, auto, 1)
    J1, J2 = J1['poses'], J2['poses']
    t = ds['nodes'].ltype.manifold[0]
    assert J2.shape == J1.shape == (ds['edges'].shape[0], t, 2, t)
    assert J2.dtype == dtype and torch.isfinite(J2).all()
    bound = BLOCK_TOL[dtype] * (1 + float(J1.abs().max()))
    torch.testing.assert_close(r2, r1, rtol=0, atol=bound)
    torch.testing.assert_close(J2, J1, rtol=0, atol=bound)


def test_residual_only_factor_keeps_the_stencil_route():
    """How J is formed does not change the route: a residual-only factor
    over one merged stencil at t = 6 takes 'stencil', as in JAX."""
    ds = load_g2o(find_data('synthetic_sphere2500_seed42.g2o'), device='cpu')
    opt = pgo_optimizer(ds, radius=1e4, cg_iter=150, cg_tol=1e-9,
                        autodiff=True)
    assert all(f.batched_jacobian is None for f in opt.factors)
    assert opt.route == 'stencil'


def test_pgo_factor_takes_a_kernel():
    """``pgo_factor(edges, poses, infos, kernel)`` as in the JAX package
    (``pypose_tpu/optim/sparse.py:980``): chi2 is the kernel's sum over
    the edges' weighted squared residuals."""
    ds = pgo_loops_instance(100, dtype=torch.float64, device='cpu')
    E = ds['edges'].shape[0]
    infos = 2.0 * torch.eye(6, dtype=torch.float64).expand(E, 6, 6)
    f = pgo_factor(ds['edges'], ds['poses'], infos, Huber(delta=0.5))
    opt = SparseLM({'poses': ds['nodes']}, [f])
    X = ds['nodes']
    r = (ds['poses'].Inv() @ (X[ds['edges'][:, 0]].Inv()
                              @ X[ds['edges'][:, 1]])).Log().tensor()
    chi = 2.0 * (r * r).sum(-1)
    want = torch.where(chi.sqrt() < 0.5, chi, chi.sqrt() - 0.25).sum()
    torch.testing.assert_close(opt._chi2(opt.params), want, rtol=1e-12,
                               atol=0)


# ---------------------------------------------------------------------------
# tests/optim/test_sparse_lm.py mirrored on identical arrays
# ---------------------------------------------------------------------------

def jax_lie(name, x):
    return getattr(jpp, name)(jnp.asarray(x))


def port_lie(name, x):
    return getattr(ppt, name)(torch.from_numpy(np.array(x)))


def check_histories(port, jax_hist):
    port, want = np.asarray(port), np.asarray(jax_hist)
    assert len(port) == len(want)
    big = want > 1e-6 * want[0]
    np.testing.assert_allclose(port[big], want[big], rtol=HIST_RTOL)


def run_steps(opt, steps):
    return [float(opt.step()) for _ in range(steps)]


def test_sim3_chain_autodiff_matches_jax():
    """test_sim3_chain_jacrev_fallback: a 30-node Sim3 chain through a
    user-written residual-only Factor."""
    N = 30
    rng = np.random.default_rng(21)
    sig = np.array([0.6] * 3 + [0.2] * 3 + [0.1])
    gt = jax_lie('sim3', (rng.normal(size=(N, 7)) * sig).astype('f4')).Exp()
    ii = jnp.arange(N - 1)
    edges = np.stack([np.arange(N - 1), np.arange(1, N)], -1)
    Z = np.asarray((gt[ii].Inv() @ gt[ii + 1]).tensor())
    noise = np.array([0.1] * 3 + [0.05] * 3 + [0.02])
    init = jax_lie('sim3', (rng.normal(size=(N, 7)) * noise).astype('f4')
                   ).Exp() @ gt
    init = np.asarray(init.tensor()).copy()
    init[0] = np.asarray(gt.tensor()[0])

    def jresid(values, Z):
        Xi, Xj = values['poses'][0], values['poses'][1]
        return (Z.Inv() @ (Xi.Inv() @ Xj)).Log().tensor()

    jopt = jsparse.SparseLM(
        {'poses': jax_lie('Sim3', init)},
        [jsparse.Factor(jresid, {'poses': jnp.asarray(edges)},
                        consts=jax_lie('Sim3', Z))],
        fixed={'poses': jnp.zeros(N, bool).at[0].set(True)}, cg_iter=100,
        cg_tol=1e-7)
    jhist = run_steps(jopt, 10)

    def tresid(values, Z):
        X = values['poses']
        return (Z.Inv() @ (X[:, 0].Inv() @ X[:, 1])).Log().tensor()

    fixed = torch.zeros(N, dtype=torch.bool)
    fixed[0] = True
    opt = SparseLM({'poses': port_lie('Sim3', init)},
                   [Factor(tresid, {'poses': torch.from_numpy(edges)},
                           consts=port_lie('Sim3', Z))],
                   fixed={'poses': fixed}, cg_iter=100, cg_tol=1e-7)
    hist = run_steps(opt, 10)
    check_histories(hist, jhist)
    assert hist[-1] < 1e-6 and jhist[-1] < 1e-6
    err = (opt.params['poses'].Inv() @ port_lie(
        'Sim3', np.asarray(gt.tensor()))).Log().tensor()
    assert float(err.abs().mean()) < 1e-3


def test_mixed_groups_ba_style_matches_jax():
    """test_mixed_groups_ba_style: 4 SE3 poses and 10 points, observed
    points in the camera frame; both groups update, pose 0 fixed."""
    C, P = 4, 10
    rng = np.random.default_rng(0)
    gt_pose = jax_lie('se3', (0.2 * rng.normal(size=(C, 6))).astype('f4')
                      ).Exp()
    gt_pts = (rng.normal(size=(P, 3)) + [0., 0., 5.]).astype('f4')
    ci, pi = (a.reshape(-1) for a in np.meshgrid(np.arange(C), np.arange(P),
                                                 indexing='ij'))
    obs = np.array(gt_pose[jnp.asarray(ci)].Act(jnp.asarray(gt_pts[pi])))
    init_pose = np.asarray((jax_lie(
        'se3', (0.05 * rng.normal(size=(C, 6))).astype('f4')).Exp()
        @ gt_pose).tensor())
    init_pts = (gt_pts + 0.1 * rng.normal(size=(P, 3))).astype('f4')

    def jresid(values, obs):
        return values['poses'][0].Act(values['points'][0]) - obs

    jopt = jsparse.SparseLM(
        {'poses': jax_lie('SE3', init_pose), 'points': jnp.asarray(init_pts)},
        [jsparse.Factor(jresid, {'poses': jnp.asarray(ci)[:, None],
                                 'points': jnp.asarray(pi)[:, None]},
                        consts=jnp.asarray(obs))],
        fixed={'poses': jnp.zeros(C, bool).at[0].set(True),
               'points': jnp.zeros(P, bool)}, cg_iter=200, cg_tol=1e-7)
    jhist = run_steps(jopt, 10)

    def tresid(values, obs):
        return values['poses'][:, 0].Act(values['points'][:, 0]) - obs

    fixed = {'poses': torch.zeros(C, dtype=torch.bool),
             'points': torch.zeros(P, dtype=torch.bool)}
    fixed['poses'][0] = True
    opt = SparseLM({'poses': port_lie('SE3', init_pose),
                    'points': torch.from_numpy(init_pts)},
                   [Factor(tresid, {'poses': torch.from_numpy(ci),
                                    'points': torch.from_numpy(pi)},
                           consts=torch.from_numpy(obs))],
                   fixed=fixed, cg_iter=200, cg_tol=1e-7)
    assert opt.route == 'einsum'
    hist = run_steps(opt, 10)
    check_histories(hist, jhist)
    assert hist[-1] < 1e-6 and jhist[-1] < 1e-6


def circle_graph(N=40, loops=6, meas_sigma=0.01, init_sigma=0.3, seed=0):
    """tests/optim/test_sparse_lm.py:circle_graph with numpy draws: an SE3
    circle of radius 10, odometry and ``loops`` loops to the far side,
    measurement and initial noise ``Exp(sigma N(0, 1))``, node 0 exact.
    Returns numpy (init [N, 7], edges [E, 2], Z [E, 7]) from the JAX
    package in float32."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, N, endpoint=False)
    half = (t + np.pi / 2) / 2
    z = np.zeros_like(t)
    gt = jax_lie('SE3', np.stack([10 * np.cos(t), 10 * np.sin(t), z, z, z,
                                  np.sin(half), np.cos(half)], -1
                                 ).astype('f4'))
    li = rng.integers(0, N, size=loops)
    ii = np.concatenate([np.arange(N), li])
    jj = np.concatenate([(np.arange(N) + 1) % N, (li + N // 2) % N])
    E = len(ii)
    Z = (gt[jnp.asarray(ii)].Inv() @ gt[jnp.asarray(jj)]) @ jax_lie(
        'se3', (meas_sigma * rng.normal(size=(E, 6))).astype('f4')).Exp()
    init = jax_lie('se3', (init_sigma * rng.normal(size=(N, 6))).astype(
        'f4')).Exp() @ gt
    init = np.asarray(init.tensor()).copy()
    init[0] = np.asarray(gt.tensor()[0])
    return init, np.stack([ii, jj], -1), np.asarray(Z.tensor())


def test_pgo_with_infos_and_kernel_matches_jax():
    """test_pgo_with_infos_and_kernel: a 40-pose circle with 6 loops,
    infos 2 I, Huber(5), the JAX package's ``pgo`` (odometry runs split,
    TrustRegion(1e4), node 0 fixed, 12 steps, stop on a rejection without
    progress or below 1e-7 of progress) and its counterpart in the
    port."""
    init, edges, Z = circle_graph()
    E = edges.shape[0]
    infos = np.broadcast_to(2.0 * np.eye(6, dtype='f4'), (E, 6, 6))
    _, jhist = jsparse.pgo(jax_lie('SE3', init), jnp.asarray(edges),
                           jax_lie('SE3', Z), infos=jnp.asarray(infos),
                           kernel=jkernel.Huber(delta=HUBER_DELTA),
                           steps=12, cg_iter=100, cg_tol=1e-6)
    runs, rest = split_chain_edges(edges)
    nodes, Zt = port_lie('SE3', init), port_lie('SE3', Z)
    factors = [pgo_factor(torch.from_numpy(edges[r]), Zt[torch.from_numpy(r)],
                          torch.from_numpy(infos[r]), Huber(delta=HUBER_DELTA))
               for r in list(runs) + ([rest] if len(rest) else [])]
    fixed = torch.zeros(len(init), dtype=torch.bool)
    fixed[0] = True
    opt = SparseLM({'poses': nodes}, factors,
                   strategy=TrustRegion(radius=1e4), fixed={'poses': fixed},
                   cg_iter=100, cg_tol=1e-6)
    hist = []
    for _ in range(12):
        hist.append(float(opt.step()))
        if opt.reject_count > 0 and (len(hist) < 2
                                     or hist[-2] - hist[-1] <= 0):
            break
        if len(hist) > 1 and hist[-2] - hist[-1] < 1e-7 * max(1.0, hist[-1]):
            break
    check_histories(hist, [float(h) for h in jhist])
    assert hist[-1] < 0.05 * hist[0]
