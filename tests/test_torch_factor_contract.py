"""``Factor``'s per-edge contract (the JAX package's,
``pypose_tpu/optim/sparse.py:55-89``): a residual of ONE edge, mapped
over the edges by ``torch.func.vmap``, a per-edge analytic ``jacobian=``
and an edge mask ``valid=``, against the JAX package on the same arrays;
``pgo()``; and the reference's own SparseLM test factors
(``tests/optim/test_sparse_lm.py``), one Python function handed to both
packages unchanged.

Tolerances: float64 chi2 within 1e-12 relative (the ring's one step is
9.008309187208692 in the JAX package); the ring's float32 steps within
1e-5 relative; the reference factors' steps within 1e-3 (float32, entries
above 1e-4 of the first: below it chi2 is within ~100 float32 roundings
of its residuals, measured 1.46e-8 against 1.47e-8 at 1.8e-6 of the
first) and 1e-9 (float64, above 1e-9 of the first); ``pgo()``'s history
within 1e-3 and its nodes within 1e-3; the per-edge Jacobians within 1e-6
(float32) and 1e-12 (float64).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu as jpp
from pypose_tpu.optim import sparse as jsp
import pypose_tpu_torch as ppt
from pypose_tpu_torch.optim import sparse as tsp
from pypose_tpu_torch.optim.sparse import Factor, SparseLM, pgo
from pypose_tpu_torch.testing import cap_threads

cap_threads()

RING_EDGES = np.array([[0, 1], [1, 2], [2, 3], [3, 0], [0, 2], [1, 3]])
C6_CHI2 = 9.008309187208692


def ring_residual(values, consts):
    """One edge's residual, as the reference writes it: values['x'] is
    this edge's [2, 2] nodes."""
    return values['x'][1] - values['x'][0] - consts


def ring_jacobian(values, consts):
    """Its per-edge analytic Jacobian: (r (2,), {'x': J [2, 2 (arity),
    2]})."""
    r = ring_residual(values, consts)
    eye = jnp.eye(2, dtype=r.dtype) if isinstance(r, jax.Array) else \
        torch.eye(2, dtype=r.dtype)
    stack = jnp.stack if isinstance(r, jax.Array) else torch.stack
    return r, {'x': stack([-eye, eye], 1)}


def ring(dtype, **factor_kw):
    """The C6 input: 4 nodes [4, 2] and measurements [6, 2] from
    ``numpy.random.default_rng(0)``, the ring plus (0, 2) and (1, 3),
    node 0 fixed: (JAX SparseLM, port SparseLM)."""
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(4, 2)).astype(dtype)
    meas = rng.normal(size=(6, 2)).astype(dtype)
    fixed = np.zeros(4, bool)
    fixed[0] = True
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in factor_kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in factor_kw.items()}
    j = jsp.SparseLM({'x': jnp.asarray(x0)},
                     [jsp.Factor(ring_residual, {'x': jnp.asarray(RING_EDGES)},
                                 consts=jnp.asarray(meas), **jkw)],
                     fixed={'x': jnp.asarray(fixed)})
    t = SparseLM({'x': torch.from_numpy(x0)},
                 [Factor(ring_residual, {'x': torch.from_numpy(RING_EDGES)},
                         consts=torch.from_numpy(meas), **tkw)],
                 fixed={'x': torch.from_numpy(fixed)})
    return j, t


def test_c6_reproducer_gives_the_reference_chi2():
    """ROADMAP.md C6: one step() of the per-edge ring residual, float64."""
    with jax.enable_x64(True):
        j, t = ring('float64')
        jchi = float(j.step())
    chi = t.step()
    assert jchi == pytest.approx(C6_CHI2, rel=1e-12, abs=0)
    assert chi == pytest.approx(C6_CHI2, rel=1e-12, abs=0)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('kind', ['residual', 'jacobian', 'valid'])
def test_factor_keywords_match_jax(kind, dtype):
    """Three steps of the ring with the autodiff Jacobian, with the
    per-edge ``jacobian=`` (also its blocks against the autodiff ones),
    and with ``valid=`` masking edges 1 and 4 out of chi2 (their weights
    zero, as the contract asks)."""
    kw = {}
    if kind == 'jacobian':
        kw['jacobian'] = ring_jacobian
    if kind == 'valid':
        valid = np.ones(6, bool)
        valid[[1, 4]] = False
        kw['valid'] = valid
        kw['weight'] = (valid[:, None, None] * np.eye(2)).astype(dtype)
    with jax.enable_x64(dtype == 'float64'):
        j, t = ring(dtype, **kw)
        jh = [float(j.step()) for _ in range(3)]
    th = [t.step() for _ in range(3)]
    rtol = 1e-5 if dtype == 'float32' else 1e-12
    np.testing.assert_allclose(th, jh, rtol=rtol)
    if kind == 'valid':
        _, plain = ring(dtype)
        assert th[0] < plain.step()
    if kind == 'jacobian':
        f = t.factors[0]
        r, J = t._edge_r_jac(t.params, f, 0)
        auto = Factor(ring_residual, f.indices, f.consts)
        r2, J2 = t._edge_r_jac(t.params, auto, 0)
        tol = 1e-6 if dtype == 'float32' else 1e-12
        np.testing.assert_allclose(J['x'].numpy(), J2['x'].numpy(),
                                   rtol=0, atol=tol)
        np.testing.assert_allclose(r.numpy(), r2.numpy(), rtol=0, atol=tol)


def ba_style_resid(values, obs):
    """tests/optim/test_sparse_lm.py:test_mixed_groups_ba_style's factor."""
    X = values['poses'][0]
    pt = values['points'][0]
    return X.Act(pt) - obs


def sim3_chain_resid(values, Z):
    """tests/optim/test_sparse_lm.py:test_sim3_chain_jacrev_fallback's."""
    Xi, Xj = values['poses'][0], values['poses'][1]
    return (Z.Inv() @ (Xi.Inv() @ Xj)).Log().tensor()


def _lie(pkg, name, a):
    if pkg == 'jax':
        return getattr(jpp, name)(jnp.asarray(a))
    return getattr(ppt, name)(torch.from_numpy(np.ascontiguousarray(a)))


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('case', ['ba_style', 'sim3_chain'])
def test_reference_test_factors_unchanged(case, dtype):
    """The reference's test factors, the same function object in both
    packages, over numpy-drawn problems: four steps' chi2.  The Sim3 chain
    takes the 'chain' route, where the JAX package's
    ``StencilSpMV.couple`` sums in float32 whatever the dtype
    (ROADMAP.md, properties of the reference): its float64 steps are held
    at 1e-4 (measured 3.4e-7)."""
    rng = np.random.default_rng(5)
    if case == 'ba_style':
        C, P = 4, 10
        pose = rng.normal(size=(C, 6)) * 0.2
        pts = rng.normal(size=(P, 3)) + [0., 0., 5.]
        ci, pi = (a.reshape(-1) for a in np.meshgrid(
            np.arange(C), np.arange(P), indexing='ij'))
        gt = ppt.se3(torch.from_numpy(pose)).Exp()
        obs = gt[torch.from_numpy(ci)].Act(torch.from_numpy(pts[pi]))
        init = (ppt.se3(torch.from_numpy(0.05 * rng.normal(size=(C, 6))))
                .Exp() @ gt).tensor().numpy()
        init[0] = gt.tensor()[0].numpy()
        params = {'poses': ('SE3', init),
                  'points': (None, pts + 0.1 * rng.normal(size=(P, 3)))}
        indices = {'poses': ci[:, None], 'points': pi[:, None]}
        consts, resid = (None, obs.numpy()), ba_style_resid
    else:
        N = 30
        sig = np.array([0.6] * 3 + [0.2] * 3 + [0.1])
        gt = ppt.sim3(torch.from_numpy(rng.normal(size=(N, 7)) * sig)).Exp()
        edges = np.stack([np.arange(N - 1), np.arange(1, N)], -1)
        Z = (gt[torch.arange(N - 1)].Inv() @ gt[torch.arange(1, N)])
        noise = np.array([0.1] * 3 + [0.05] * 3 + [0.02])
        init = (ppt.sim3(torch.from_numpy(rng.normal(size=(N, 7)) * noise))
                .Exp() @ gt).tensor().numpy()
        init[0] = gt.tensor()[0].numpy()
        params = {'poses': ('Sim3', init)}
        indices = {'poses': edges}
        consts, resid = ('Sim3', Z.tensor().numpy()), sim3_chain_resid

    def build(pkg):
        arr = jnp.asarray if pkg == 'jax' else torch.from_numpy
        ps = {n: (arr(v.astype(dtype)) if lt is None
                  else _lie(pkg, lt, v.astype(dtype)))
              for n, (lt, v) in params.items()}
        c = consts[1].astype(dtype)
        c = arr(c) if consts[0] is None else _lie(pkg, consts[0], c)
        fixed = {n: np.zeros(v[1].shape[0], bool) for n, v in params.items()}
        fixed['poses'][0] = True
        sp = jsp if pkg == 'jax' else tsp
        return sp.SparseLM(
            ps, [sp.Factor(resid, {n: arr(i) for n, i in indices.items()},
                           consts=c)],
            fixed={n: arr(m) for n, m in fixed.items()}, cg_iter=200,
            cg_tol=1e-7)
    with jax.enable_x64(dtype == 'float64'):
        jopt = build('jax')
        jh = [float(jopt.step()) for _ in range(4)]
    topt = build('torch')
    th = [topt.step() for _ in range(4)]
    keep = np.asarray(jh) > (1e-4 if dtype == 'float32' else 1e-9) * jh[0]
    rtol = 1e-3 if dtype == 'float32' else \
        1e-4 if case == 'sim3_chain' else 1e-9
    np.testing.assert_allclose(np.asarray(th)[keep], np.asarray(jh)[keep],
                               rtol=rtol)
    assert th[-1] < 1e-3 * th[0]


@pytest.mark.parametrize('split_chains', [True, False])
def test_pgo_matches_jax(split_chains):
    """``pgo()`` (pypose_tpu/optim/sparse.py:1066-1113, the entry point of
    examples/pgo.py) on a numpy-drawn 150-pose SE3 ring with loops to the
    far side, float32: the chi2 history and the nodes."""
    rng = np.random.default_rng(2)
    N = 150
    t = np.linspace(0, 2 * np.pi, N, endpoint=False)
    half = (t + np.pi / 2) / 2
    z = np.zeros_like(t)
    gt = ppt.SE3(torch.from_numpy(np.stack(
        [10 * np.cos(t), 10 * np.sin(t), z, z, z, np.sin(half),
         np.cos(half)], -1)))
    ii = np.arange(N)
    li = rng.integers(0, N, 10)
    edges = np.stack([np.concatenate([ii, li]),
                      np.concatenate([(ii + 1) % N, (li + N // 2) % N])], -1)
    E = edges.shape[0]
    e = torch.from_numpy(edges)
    Z = (gt[e[:, 0]].Inv() @ gt[e[:, 1]]) @ ppt.se3(
        torch.from_numpy(0.01 * rng.normal(size=(E, 6)))).Exp()
    init = ppt.se3(torch.from_numpy(0.1 * rng.normal(size=(N, 6)))).Exp() @ gt
    init = init.tensor().numpy().astype('f4')
    init[0] = gt.tensor()[0].numpy()
    Zn = Z.tensor().numpy().astype('f4')
    jn, jh = jsp.pgo(jpp.SE3(jnp.asarray(init)), jnp.asarray(edges), jpp.SE3(
        jnp.asarray(Zn)), steps=6, cg_iter=100, cg_tol=1e-6,
        split_chains=split_chains)
    tn, th = pgo(ppt.SE3(torch.from_numpy(init)), torch.from_numpy(edges),
                 ppt.SE3(torch.from_numpy(Zn)), steps=6, cg_iter=100,
                 cg_tol=1e-6, split_chains=split_chains)
    n = min(len(th), len(jh))
    assert n >= 3
    keep = np.asarray(jh[:n]) > 1e-6 * jh[0]
    np.testing.assert_allclose(np.asarray(th[:n])[keep],
                               np.asarray(jh[:n])[keep], rtol=1e-3)
    assert th[-1] < 0.05 * th[0]
    np.testing.assert_allclose(tn.tensor().numpy(), np.asarray(jn.tensor()),
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(tn.tensor()[0].numpy(), init[0])
