"""Pose graphs over SO3, SE3, RxSO3 and Sim3 in the port against the JAX
package on the same numpy inputs (CPU): ``pgo_factor``'s residuals and
closed-form Jacobian blocks, ``SparseLM.step()`` on a small sphere per
group, the random-loop graphs of ``bench.py:bench_pgo_groups``, the
block-Jacobi inverse at the block sizes without a closed form, and the
route each block size takes.

Tolerances.  (r, J): 1e-6 (1 + max) in float32 and 1e-12 in float64, as
``tests/test_torch_groups.py`` holds the functions they are built from;
Sim3's J carries ``sim3_Jl_inv``'s float32 spread (2e-5, stated there).
LM steps: chi2 per step rtol 1e-3 in float32 (capped CG solves summing in
another order, as in ``tests/test_torch_sparse_lm.py``) and 1e-8 in
float64, parameters within 1e-3 / 1e-8 in ``|Log(a^-1 b)|``; Sim3 in
float32 within 5e-3 (measured 2.4e-3 after three steps whose solves all
stop at the 150-iteration cap: translations of magnitude 25, so 1e-4 of
them, with ``sim3_Jl_inv``'s float32 spread in every Jacobian block).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu as jpp
from pypose_tpu.ops import smallinv as jinv
from pypose_tpu.optim import sparse as jsp
from pypose_tpu.optim.strategy import TrustRegion as JTrustRegion
import pypose_tpu_torch as ppt
from pypose_tpu_torch.datasets import synthetic_sphere
from pypose_tpu_torch.ops import smallinv as tinv
from pypose_tpu_torch.optim import sparse as tsp
from pypose_tpu_torch.testing import (assert_close, pgo_group_instance,
                                      pgo_loops_instance, pgo_optimizer,
                                      ring3_problem)
from pypose_tpu_torch.testing import cap_threads

cap_threads()

GROUPS = ['SO3', 'SE3', 'RxSO3', 'Sim3']
TAN = {'SO3': 3, 'SE3': 6, 'RxSO3': 4, 'Sim3': 7}
DTYPES = ['float32', 'float64']


def jlie(group, x):
    return getattr(jpp, group)(jnp.asarray(x.tensor().numpy()))


def instance(group, dtype, n=100):
    ds = synthetic_sphere(n, dtype=getattr(torch, dtype), device='cpu')
    return pgo_group_instance(ds, group, torch.Generator().manual_seed(11))


def jax_pgo(ds, group, radius, cg_iter, cg_tol, split_chains=True):
    """The JAX package's SparseLM on a port pose-graph dict of ``group``,
    as testing.pgo_optimizer builds the port's."""
    edges = jnp.asarray(ds['edges'].numpy().astype(np.int32))
    Z = jlie(group, ds['poses'])
    if split_chains:
        runs, rest = jsp.split_chain_edges(edges)
        factors = [jsp.pgo_factor(edges[jnp.asarray(r)], Z[jnp.asarray(r)])
                   for r in list(runs) + ([rest] if len(rest) else [])]
    else:
        factors = [jsp.pgo_factor(edges, Z)]
    N = ds['nodes'].shape[0]
    return jsp.SparseLM({'poses': jlie(group, ds['nodes'])}, factors,
                        strategy=JTrustRegion(radius=radius),
                        fixed={'poses': jnp.zeros(N, bool).at[0].set(True)},
                        cg_iter=cg_iter, cg_tol=cg_tol)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('group', GROUPS)
def test_pgo_factor_r_and_J_match_jax(group, dtype):
    """One seeded 200-edge graph: the port's batched closed form against
    the JAX factor's per-edge ``jacobian``, vmapped."""
    rng = np.random.default_rng(7)
    n, E = 60, 200
    edges = np.stack([rng.integers(0, n, E), rng.integers(0, n, E)], 1)
    gen = torch.Generator().manual_seed(3)
    tdt = getattr(torch, dtype)
    sig = {'SO3': 1.0, 'SE3': 1.0, 'RxSO3': (1.0, 0.3),
           'Sim3': (1.0, 1.0, 0.3)}[group]
    lt = getattr(ppt.lietensor, group + '_type')
    X = lt.randn(n, sigma=sig, generator=gen, dtype=tdt)
    Z = lt.randn(E, sigma=sig, generator=gen, dtype=tdt)
    tf = tsp.pgo_factor(torch.from_numpy(edges), Z)
    r, J = tf.batched_jacobian({'poses': X[torch.from_numpy(edges)]}, Z)
    assert tuple(J['poses'].shape) == (E, TAN[group], 2, TAN[group])
    r_res = tf.residuals({'poses': X[torch.from_numpy(edges)]}, Z)
    with jax.enable_x64(dtype == 'float64'):
        jf = jsp.pgo_factor(jnp.asarray(edges), jlie(group, Z))
        jr, jJ = jax.vmap(jf.jacobian)(
            {'poses': jlie(group, X)[jnp.asarray(edges)]}, jlie(group, Z))
        jr, jJ = np.asarray(jr), np.asarray(jJ['poses'])
    tol = 1e-6 if dtype == 'float32' else 1e-12
    jtol = 2e-5 if (group, dtype) == ('Sim3', 'float32') else \
        10 * tol if group == 'Sim3' else tol
    np.testing.assert_allclose(r.numpy(), jr, rtol=0,
                               atol=tol * (1 + np.abs(jr).max()))
    np.testing.assert_allclose(r_res.numpy(), jr, rtol=0,
                               atol=tol * (1 + np.abs(jr).max()))
    np.testing.assert_allclose(J['poses'].numpy(), jJ, rtol=0,
                               atol=jtol * (1 + np.abs(jJ).max()))


def test_pgo_factor_refuses_other_types():
    """A type with no closed form (it raised until the autograd slice)
    gets a residual-only factor, as in the JAX package
    (``pypose_tpu/optim/sparse.py:1021-1022``): SparseLM takes its
    Jacobian by autodiff."""
    x = ppt.identity_se3(4)
    f = tsp.pgo_factor(torch.tensor([[0, 1]]), x[:1])
    assert f.batched_jacobian is None and f.num_edges == 1


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('group', GROUPS)
def test_sparse_lm_steps_match_jax(group, dtype):
    """Three LM steps on a 100-pose sphere over ``group``: route 'stencil'
    (its plain version here) in float32, 'einsum' in float64; the JAX
    package takes its plain stencil CG for both."""
    ds = instance(group, dtype)
    sched = dict(radius=1e4, cg_iter=150, cg_tol=1e-9)
    topt = pgo_optimizer(ds, **sched)
    f32 = dtype == 'float32'
    assert topt.route == ('stencil' if f32 else 'einsum')
    assert topt._stencil_all.tan == TAN[group]
    with jax.enable_x64(not f32):
        jopt = jax_pgo(ds, group, **sched)
        jhist = [jopt.step() for _ in range(3)]
        jX = np.array(jopt.params['poses'].tensor())
    thist = [topt.step() for _ in range(3)]
    np.testing.assert_allclose(thist, jhist, rtol=1e-3 if f32 else 1e-8)
    assert thist[-1] < 0.1 * thist[0] or group in ('SO3', 'RxSO3')
    assert_close(topt.params['poses'],
                 getattr(ppt, group)(torch.from_numpy(jX)),
                 atol=1e-8 if not f32 else 5e-3 if group == 'Sim3' else 1e-3)


@pytest.mark.parametrize('group', ['SO3', 'Sim3'])
def test_loops_instance_matches_jax(group):
    """bench_pgo_groups' ring plus random loops at N = 300, float32: route
    'einsum' through CouplingSpMV on both sides; block-Jacobi scalarized
    at t = 3 and through ``blockinv`` (a library inverse) at t = 7.  With
    exact measurements chi2 heads for zero: entries above 1e-6 within
    2e-3, and the end below 1e-6 of the start."""
    ds = pgo_loops_instance(300, device='cpu', group=group)
    assert ds['nodes'].ltype.name == group
    sched = dict(radius=1e4, cg_iter=100, cg_tol=1e-8, split_chains=False)
    topt = pgo_optimizer(ds, **sched)
    assert topt.route == 'einsum'
    jopt = jax_pgo(ds, group, **sched)
    jopt.optimize(steps=4, decreasing=1e-10, patience=2)
    topt.optimize(steps=4, decreasing=1e-10, patience=2)
    want, got = np.asarray(jopt.history), np.asarray(topt.history)
    assert len(got) == len(want)
    big = want > 1e-6
    np.testing.assert_allclose(got[big], want[big], rtol=2e-3)
    assert got[-1] < 1e-6 * got[0] and want[-1] < 1e-6 * want[0]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('n', [4, 7, 5])
def test_blockinv_other_sizes_match_jax(n, dtype):
    """Sizes without a closed form fall to the library inverse in both
    packages, on the inputs' device; ``blockinv_scalar`` has none and
    raises, so SparseLM's einsum route uses ``blockinv`` there."""
    rng = np.random.default_rng(n)
    a = rng.normal(size=(50, n, n))
    M = (a @ a.transpose(0, 2, 1) + n * np.eye(n)).astype(dtype)
    got = tinv.blockinv(torch.from_numpy(M))
    with jax.enable_x64(dtype == 'float64'):
        want = np.asarray(jinv.blockinv(jnp.asarray(M)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 if dtype == 'float32' else 1e-13)
    with pytest.raises(NotImplementedError):
        tinv.blockinv_scalar([torch.ones(3)] * (n * n))


@pytest.mark.parametrize('t,dtype,route', [
    (3, 'float32', 'stencil'), (4, 'float32', 'stencil'),
    (6, 'float32', 'stencil'), (7, 'float32', 'stencil'),
    (5, 'float32', 'stencil'), (3, 'float64', 'einsum'),
    (7, 'float64', 'einsum'), (5, 'float64', 'einsum')])
def test_route_by_block_size(t, dtype, route):
    """A merged-stencil, block-Jacobi graph takes 'stencil' in float32 at
    every block size (t = 5: the kernels' runtime-t instantiation on the
    card), 'einsum' in float64."""
    groups = {3: 'SO3', 4: 'RxSO3', 6: 'SE3', 7: 'Sim3'}
    if t in groups:
        opt = pgo_optimizer(instance(groups[t], dtype, n=40), radius=1e4,
                            cg_iter=10, cg_tol=1e-6)
        assert opt.route == route
    params, factors, fixed = ring3_problem(dtype=getattr(torch, dtype),
                                           device='cpu', t=t)
    opt = tsp.SparseLM(params, factors, fixed=fixed)
    assert opt._stencil_all is not None and opt._stencil_all.tan == t
    assert opt.route == route
    assert (opt._spmv is None) == (route == 'stencil')
    assert tsp.SparseLM(params, factors, fixed=fixed,
                        precond='chain').route == 'chain'


@pytest.mark.parametrize('group', ['SO3', 'RxSO3', 'Sim3'])
def test_group_instance_is_seeded_and_shaped(group):
    ds = synthetic_sphere(50, device='cpu')
    a = pgo_group_instance(ds, group, torch.Generator().manual_seed(5))
    b = pgo_group_instance(ds, group, torch.Generator().manual_seed(5))
    t = TAN[group]
    assert a['nodes'].ltype.name == a['poses'].ltype.name == group
    assert tuple(a['infos'].shape) == (ds['edges'].shape[0], t, t)
    assert torch.equal(a['nodes'].tensor(), b['nodes'].tensor())
    assert torch.equal(a['nodes'].rotation().tensor(),
                       ds['nodes'].rotation().tensor())
    assert float((a['poses'].scale() - 1).abs().max()) == 0.0
    if group == 'SO3':
        return
    s = a['nodes'].scale()
    assert 0.02 < float(torch.log(s).std()) < 0.1
    with pytest.raises(TypeError, match='Generator'):
        pgo_group_instance(ds, group)
    assert pgo_group_instance(ds, 'SE3') is ds
