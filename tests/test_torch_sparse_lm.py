"""The whole slice on the CPU: the port's SparseLM against the JAX
package's on synthetic_sphere(100) and (300), made by the JAX package and
carried over as numpy, in float32 and float64; plus the formation pieces
one by one, the information-weighted path, and the refusals.

Tolerances: chi2 per step rtol 1e-3 in float32 (the CG runs to its
150-iteration cap and its sums run in another order, so each step's
delta differs in the last digits and the LM trajectory follows) and
1e-8 in float64; final poses within 1e-3 rad/m (float32) and 1e-8
(float64) as group errors.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pypose_tpu.datasets import synthetic_sphere
from pypose_tpu.optim import sparse as jsp
from pypose_tpu.optim.strategy import TrustRegion as JTrustRegion
import pypose_tpu_torch as ppt
from pypose_tpu_torch.optim import sparse as tsp
from pypose_tpu_torch.optim.strategy import TrustRegion
from pypose_tpu_torch.testing import (assert_close, params_from_numpy,
                                      strategy_state_from_numpy)
from pypose_tpu_torch.testing import cap_threads

cap_threads()

CG = dict(cg_iter=150, cg_tol=1e-9)


def jax_problem(n, dtype, info='identity'):
    ds = synthetic_sphere(n, dtype=dtype, info=info)
    edges = jnp.asarray(ds['edges'])
    runs, rest = jsp.split_chain_edges(edges)
    weighted = info != 'identity'
    factors = []
    for rows in list(runs) + [rest]:
        rows = jnp.asarray(rows)
        factors.append(jsp.pgo_factor(
            edges[rows], ds['poses'][rows],
            ds['infos'][rows] if weighted else None))
    fixed = jnp.zeros(n, bool).at[0].set(True)
    opt = jsp.SparseLM({'poses': ds['nodes']}, factors,
                       strategy=JTrustRegion(radius=1e4),
                       fixed={'poses': fixed}, **CG)
    return ds, opt


def torch_problem(ds, weighted=False, nodes=None, strategy_state=None):
    """The same problem in the port, from the JAX arrays as numpy;
    ``nodes`` and ``strategy_state`` (JAX values) replace the initial
    poses and TrustRegion state."""
    edges = np.asarray(ds['edges'])
    Z = np.asarray(ds['poses'].tensor())
    infos = np.asarray(ds['infos'])
    nodes = ds['nodes'] if nodes is None else nodes
    params = params_from_numpy({'poses': np.asarray(nodes.tensor())},
                               {'poses': 'SE3'})
    runs, rest = tsp.split_chain_edges(edges)
    factors = [tsp.pgo_factor(
        torch.from_numpy(edges[rows]), ppt.SE3(torch.from_numpy(Z[rows])),
        torch.from_numpy(infos[rows]) if weighted else None)
        for rows in list(runs) + [rest]]
    fixed = torch.zeros(edges.max() + 1, dtype=torch.bool)
    fixed[0] = True
    opt = tsp.SparseLM(params, factors, strategy=TrustRegion(radius=1e4),
                       fixed={'poses': fixed}, **CG)
    if strategy_state is not None:
        opt.strategy_state = strategy_state_from_numpy(
            {k: np.asarray(v) for k, v in strategy_state.items()})
    return opt


@pytest.mark.parametrize('n', [100, 300])
def test_optimize_matches_jax_f32(n):
    """optimize(steps=4) from the same start; then a second port optimizer
    takes over the JAX optimizer's poses and TrustRegion state, as
    bench.py hands phase 1's state to phase 2, and both run
    optimize(steps=4) again."""
    ds, jopt = jax_problem(n, jnp.float32)
    topt = torch_problem(ds)
    jopt.optimize(steps=4)
    topt.optimize(steps=4)
    assert len(topt.history) == len(jopt.history) == 4
    np.testing.assert_allclose(topt.history, jopt.history, rtol=1e-3)
    assert_close(topt.params['poses'],
                 ppt.SE3(torch.from_numpy(
                     np.array(jopt.params['poses'].tensor()))), atol=1e-3)
    np.testing.assert_allclose(topt.strategy_state['damping'].item(),
                               float(jopt.strategy_state['damping']),
                               rtol=1e-3)
    handoff = torch_problem(ds, nodes=jopt.params['poses'],
                            strategy_state=jopt.strategy_state)
    jopt.optimize(steps=4)
    handoff.optimize(steps=4)
    assert len(handoff.history) == len(jopt.history)
    np.testing.assert_allclose(handoff.history, jopt.history, rtol=1e-3)


@pytest.mark.parametrize('n', [100, 300])
def test_steps_match_jax_f64(n):
    """float64: the JAX optimize() carries float32 loop state and cannot
    run under x64 (pypose_tpu/optim/sparse.py:920,956), so both packages
    take four step() calls, which run the same _core."""
    with jax.enable_x64(True):
        ds, jopt = jax_problem(n, jnp.float64)
        jhist = [jopt.step() for _ in range(4)]
        jposes = np.array(jopt.params['poses'].tensor())
    topt = torch_problem(ds)
    assert topt.dtype == torch.float64
    thist = [topt.step() for _ in range(4)]
    np.testing.assert_allclose(thist, jhist, rtol=1e-8)
    assert_close(topt.params['poses'], ppt.SE3(torch.from_numpy(jposes)),
                 atol=1e-8)


@pytest.mark.parametrize('info', ['identity', 'natural'])
def test_formation_matches_jax(info):
    """chi2, b = -J^T W r, diag(J^T W J), its diagonal blocks and the
    merged coupling channels, float64, at the initial poses."""
    weighted = info != 'identity'
    with jax.enable_x64(True):
        ds, jopt = jax_problem(100, jnp.float64, info)
        fdata = jopt._factor_data()
        jblocks = [jopt._weighted(f, fd, *jopt._edge_r_jac(
            jopt.params, f, fd, fi))
            for fi, (f, fd) in enumerate(zip(jopt.factors, fdata))]
        j = dict(chi2=jopt._chi2(jopt.params, fdata),
                 b=jopt._rhs(jblocks, fdata)['poses'],
                 diag=jopt._diag(jblocks, fdata)['poses'],
                 accum=jopt._block_diag_accum(jblocks, fdata)['poses'],
                 C=jopt._stencil_all.precompute_multi(
                     [(bl[1]['poses'], bl[3]['poses']) for bl in jblocks]))
        j = {k: np.asarray(v) for k, v in j.items()}
    topt = torch_problem(ds, weighted)
    tblocks = [topt._weighted(f, *topt._edge_r_jac(topt.params, f, fi))
               for fi, f in enumerate(topt.factors)]
    t = dict(chi2=topt._chi2(topt.params),
             b=topt._rhs(tblocks)['poses'],
             diag=topt._diag(tblocks)['poses'],
             accum=topt._block_diag_accum(tblocks)['poses'],
             C=topt._stencil_all.precompute_multi(
                 [(bl[1]['poses'], bl[3]['poses']) for bl in tblocks]))
    assert topt._stencil_all.offsets == jopt._stencil_all.offsets
    assert topt.precond == jopt.precond == 'jacobi'
    for k in j:
        np.testing.assert_allclose(t[k].numpy(), j[k], rtol=1e-10,
                                   atol=1e-10, err_msg=k)


def test_split_chain_edges_matches_jax():
    rng = np.random.default_rng(0)
    chain = np.stack([np.arange(199), np.arange(1, 200)], 1)
    chain = np.delete(chain, [30, 150], axis=0)        # three runs
    edges = np.concatenate([chain, rng.integers(0, 200, (40, 2))])
    edges = edges[rng.permutation(len(edges))]
    for min_run in (8, 64):
        truns, trest = tsp.split_chain_edges(torch.from_numpy(edges),
                                             min_run)
        jruns, jrest = jsp.split_chain_edges(edges, min_run)
        assert len(truns) == len(jruns)
        for a, b in zip(truns, jruns):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(trest, jrest)


def test_refusals():
    """What raised before it was ported now builds: Constant and Adaptive
    (C5; the strategy does not change the route), precond='chain', graphs
    off one merged stencil, pgo_factor over SO3, RxSO3 and Sim3, factors
    without a closed-form Jacobian and pgo_factor over other types (a
    residual-only factor); a residual-only factor keeps the 'stencil'
    route."""
    from pypose_tpu_torch.optim.strategy import Adaptive, Constant
    opt = torch_problem(synthetic_sphere(100))
    assert opt.route == 'stencil'
    assert tsp.SparseLM(opt.params, opt.factors,
                        precond='chain').route == 'chain'
    for strategy in (Constant(1e-6), Adaptive()):
        assert tsp.SparseLM(opt.params, opt.factors,
                            strategy=strategy).route == 'stencil'
    so3 = tsp.pgo_factor(torch.zeros((3, 2), dtype=torch.int64),
                         ppt.identity_SO3(3))
    assert so3.batched_jacobian is not None and so3.num_edges == 3
    alg = tsp.pgo_factor(torch.zeros((3, 2), dtype=torch.int64),
                         ppt.so3(torch.zeros(3, 3)))
    assert alg.batched_jacobian is None
    autodiff = [tsp.Factor(f.residual, f.indices, f.consts)
                for f in opt.factors]
    assert tsp.SparseLM(opt.params, autodiff).route == 'stencil'
    # every edge offset distinct: no merged stencil
    N = 40
    edges = torch.stack([torch.arange(20), torch.arange(20) * 2 + 1], 1)
    Z = ppt.identity_SE3(20)
    off = tsp.SparseLM({'poses': ppt.identity_SE3(N)},
                       [tsp.pgo_factor(edges, Z)])
    assert off.route == 'einsum' and off._stencil_all is None


def test_docstring_examples():
    import doctest
    from pypose_tpu_torch.lietensor import lietensor
    for module in (tsp, lietensor):
        result = doctest.testmod(module)
        assert result.attempted > 0 and result.failed == 0, module
