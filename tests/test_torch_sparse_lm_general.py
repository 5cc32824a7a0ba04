"""SparseLM's general routes on the CPU against the JAX package on the same
numpy inputs: 'chain' (the BCR chain preconditioner), 'einsum' through
per-factor CouplingSpMV and through the generic gather matvec (two
variable groups), the inputs the stencil kernels do not take (float64
sphere graphs; a Euclidean t = 3 factor in float64, which in float32
takes 'stencil', as it does at every t), and the route predicate.

Tolerances.  float64 against the JAX package: chi2 per step rtol 1e-8
and poses within 1e-8, except where the JAX package's stencil couple
carries a graph (the chain route's odometry factor): it accumulates in
float32 whatever the dtype (``pypose_tpu/ops/spmv.py:267-283``), and the
two packages then differ after three steps by 6.2e-5 in chi2 and 6.1e-4
in the poses under this suite's XLA flags (tests/conftest.py: backend
optimisation level 0; 1.1e-5 in chi2 at XLA's default level), measured
on the CPU and held within 2e-4 and 2e-3.
float64 against a dense solve: the first LM solve of each general route
against numpy's solve of the same damped J^T W J, built edge by edge
from the port's Jacobian blocks (independent of either package's
matvec), within 1e-8 of the largest entry.  float32: chi2 per step rtol
1e-3, as in tests/test_torch_sparse_lm.py (CG sums in another order,
capped solves).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pypose_tpu.lietensor.utils import SE3 as JSE3
from pypose_tpu.optim import sparse as jsp
from pypose_tpu.optim.strategy import TrustRegion as JTrustRegion
import pypose_tpu_torch as ppt
from pypose_tpu_torch.datasets import synthetic_sphere
from pypose_tpu_torch.ops.spmv import CouplingSpMV, StencilSpMV
from pypose_tpu_torch.optim import sparse as tsp
from pypose_tpu_torch.optim.strategy import TrustRegion
from pypose_tpu_torch.testing import (assert_close, pgo_loops_instance,
                                      pgo_optimizer, ring3_problem)
from pypose_tpu_torch.testing import cap_threads

cap_threads()

def jax_pgo(ds, radius, cg_iter, cg_tol, split_chains=True):
    """The JAX package's SparseLM on a port pose-graph dict (as numpy), as
    testing.pgo_optimizer builds the port's."""
    edges = jnp.asarray(ds['edges'].numpy().astype(np.int32))
    Z = JSE3(jnp.asarray(ds['poses'].tensor().numpy()))
    if split_chains:
        runs, rest = jsp.split_chain_edges(edges)
        factors = [jsp.pgo_factor(edges[jnp.asarray(r)], Z[jnp.asarray(r)])
                   for r in list(runs) + ([rest] if len(rest) else [])]
    else:
        factors = [jsp.pgo_factor(edges, Z)]
    N = ds['nodes'].shape[0]
    return jsp.SparseLM({'poses': JSE3(jnp.asarray(
        ds['nodes'].tensor().numpy()))}, factors,
        strategy=JTrustRegion(radius=radius),
        fixed={'poses': jnp.zeros(N, bool).at[0].set(True)},
        cg_iter=cg_iter, cg_tol=cg_tol)


def assert_poses_close(topt, jopt, atol):
    assert_close(topt.params['poses'], ppt.SE3(torch.from_numpy(
        np.array(jopt.params['poses'].tensor()))), atol=atol)


CHAIN = dict(radius=1e4, cg_iter=200, cg_tol=1e-10)


def chain_instance(dtype):
    return synthetic_sphere(300, loops_per_pose=0.04, seed=5, dtype=dtype,
                            device='cpu')


def test_chain_route_steps_match_jax_f64():
    """Solves run to convergence (the float32-capped schedule would let
    the last iterations' rounding through); the JAX package's float32
    couple accumulation sets the tolerance (module docstring)."""
    ds = chain_instance(torch.float64)
    sched = dict(CHAIN, cg_iter=1000, cg_tol=1e-12)
    topt = pgo_optimizer(ds, **sched)
    with jax.enable_x64(True):
        jopt = jax_pgo(ds, **sched)
        jhist = [jopt.step() for _ in range(3)]
    assert topt.route == 'chain' == jopt.precond
    assert [type(s) for s in topt._spmv] == [StencilSpMV, CouplingSpMV]
    thist = [topt.step() for _ in range(3)]
    np.testing.assert_allclose(thist, jhist, rtol=2e-4)
    assert_poses_close(topt, jopt, 2e-3)


def test_chain_route_optimize_matches_jax_f32():
    """cg_iter 1000: the last two solves stall above cg_tol 1e-6 in
    float32 and run to the cap on both sides; at a 200 cap the trajectory
    follows each package's last bits (the JAX package's own runs at
    XLA's default and level-0 backends differ by 7.2e-4 at step 1).
    Measured gaps: 4.3e-4 under this suite's XLA flags, 7.9e-4 at
    XLA's default level."""
    ds = chain_instance(torch.float32)
    sched = dict(CHAIN, cg_iter=1000, cg_tol=1e-6)
    topt = pgo_optimizer(ds, **sched)
    jopt = jax_pgo(ds, **sched)
    jopt.optimize(steps=4)
    topt.optimize(steps=4)
    assert len(topt.history) == len(jopt.history)
    np.testing.assert_allclose(topt.history, jopt.history, rtol=1e-3)


def test_chain_preconditioner_matches_jax():
    """M(x) of the chain preconditioner, fixed node included (identity
    block, no couplings), float64, on the same blocks."""
    ds = chain_instance(torch.float64)
    topt = pgo_optimizer(ds, **CHAIN)
    with jax.enable_x64(True):
        jopt = jax_pgo(ds, **CHAIN)
        fd = jopt._factor_data()
        jb = [jopt._weighted(f, d, *jopt._edge_r_jac(jopt.params, f, d, i))
              for i, (f, d) in enumerate(zip(jopt.factors, fd))]
        jM = jopt._chain_preconditioner(
            jb, jopt._block_diag_accum(jb, fd), {'poses': 1.5})
        x = np.random.default_rng(0).normal(size=(300, 6))
        want = np.asarray(jM({'poses': jnp.asarray(x)})['poses'])
    tb = [topt._weighted(f, *topt._edge_r_jac(topt.params, f, i))
          for i, f in enumerate(topt.factors)]
    tM = topt._chain_preconditioner(tb, topt._block_diag_accum(tb),
                                    {'poses': 1.5})
    got = tM({'poses': torch.from_numpy(x)})['poses'].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


LOOPS = dict(radius=1e4, cg_iter=100, cg_tol=1e-8, split_chains=False)


def test_einsum_route_coupling_matches_jax():
    """pgo_loops_instance(500): one factor, CouplingSpMV (499 chain rows
    by slice, the rest one-hot), scalarized block-Jacobi; optimize in
    float32, step in float64."""
    ds = pgo_loops_instance(500, device='cpu')
    topt = pgo_optimizer(ds, **LOOPS)
    (sp,) = topt._spmv
    assert topt.route == 'einsum' and isinstance(sp, CouplingSpMV)
    assert sp._chain_contig and len(sp.chain_rows) == 499
    jopt = jax_pgo(ds, **LOOPS)
    jopt.optimize(steps=4, decreasing=1e-10)
    topt.optimize(steps=4, decreasing=1e-10)
    np.testing.assert_allclose(topt.history, jopt.history, rtol=1e-3)
    ds64 = pgo_loops_instance(500, dtype=torch.float64, device='cpu')
    topt = pgo_optimizer(ds64, **LOOPS)
    with jax.enable_x64(True):
        jopt = jax_pgo(ds64, **LOOPS)
        jhist = [jopt.step() for _ in range(3)]
    np.testing.assert_allclose([topt.step() for _ in range(3)], jhist,
                               rtol=1e-8)
    assert_poses_close(topt, jopt, 1e-8)


def two_group_problem(lib, dtype):
    """Landmarks 'b' [12, 3] seen from points 'a' [8, 3] (r = b_j - a_i -
    z) plus a prior on 'a' (r = a_i - p_i): the generic gather matvec
    (two groups, arity 1 each).  Returns (params, factors) in ``lib``
    ('jax' or 'torch')."""
    rng = np.random.default_rng(3)
    a_true, b_true = rng.normal(size=(8, 3)), rng.normal(size=(12, 3))
    ia, ib = rng.integers(0, 8, 40), rng.integers(0, 12, 40)
    ib[:12] = np.arange(12)
    z = b_true[ib] - a_true[ia] + 0.01 * rng.normal(size=(40, 3))
    p = a_true + 0.01 * rng.normal(size=(8, 3))
    a0 = a_true + 0.3 * rng.normal(size=(8, 3))
    b0 = b_true + 0.3 * rng.normal(size=(12, 3))
    xp, F = (jnp, jsp.Factor) if lib == 'jax' else (torch, tsp.Factor)
    arr = (lambda v: jnp.asarray(v, dtype)) if lib == 'jax' else \
        (lambda v: torch.tensor(v, dtype=dtype))
    eye = arr(np.eye(3))

    def obs_r(v, c):
        return v['b'][..., 0, :] - v['a'][..., 0, :] - c

    def obs_j(v, c):
        E = c.shape[0]
        J = xp.stack([eye] * E)[:, :, None, :]
        return obs_r(v, c), {'a': -J, 'b': J}

    def prior_r(v, c):
        return v['a'][..., 0, :] - c

    def prior_j(v, c):
        return prior_r(v, c), {'a': xp.stack([eye] * c.shape[0])[:, :, None]}
    factors = [F(obs_r, {'a': ia, 'b': ib}, arr(z), batched_jacobian=obs_j),
               F(prior_r, {'a': np.arange(8)}, arr(p),
                 batched_jacobian=prior_j)]
    return {'a': arr(a0), 'b': arr(b0)}, factors


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_generic_matvec_two_groups_matches_jax(dtype):
    with jax.enable_x64(dtype == 'float64'):
        jp, jf = two_group_problem('jax', getattr(jnp, dtype))
        jopt = jsp.SparseLM(jp, jf, strategy=JTrustRegion(radius=1e4),
                            cg_iter=100, cg_tol=1e-10)
        jhist = [jopt.step() for _ in range(3)]
        jparams = {n: np.asarray(v) for n, v in jopt.params.items()}
    tp, tf = two_group_problem('torch', getattr(torch, dtype))
    topt = tsp.SparseLM(tp, tf, strategy=TrustRegion(radius=1e4),
                        cg_iter=100, cg_tol=1e-10)
    assert topt.route == 'einsum' and topt._spmv is None
    thist = [topt.step() for _ in range(3)]
    f32 = dtype == 'float32'
    np.testing.assert_allclose(thist, jhist, rtol=1e-3 if f32 else 1e-8)
    for n in jparams:
        np.testing.assert_allclose(topt.params[n].numpy(), jparams[n],
                                   atol=1e-4 if f32 else 1e-10)


def test_c2_sphere_f64_matches_jax():
    """The float64 input of C2 (synthetic_sphere(100), float64): route
    'einsum' here, the plain stencil CG in the JAX package; the same
    system to the same tolerance."""
    ds = synthetic_sphere(100, dtype=torch.float64, device='cpu')
    sched = dict(radius=1e4, cg_iter=150, cg_tol=1e-9)
    topt = pgo_optimizer(ds, **sched)
    assert topt.route == 'einsum'
    with jax.enable_x64(True):
        jopt = jax_pgo(ds, **sched)
        jhist = [jopt.step() for _ in range(3)]
    np.testing.assert_allclose([topt.step() for _ in range(3)], jhist,
                               rtol=1e-8)
    assert_poses_close(topt, jopt, 1e-8)


def jax_ring3(params, factors, fixed):
    """The JAX package's SparseLM on testing.ring3_problem's data, at the
    block size t of its points (3 unless the problem was drawn at
    another)."""
    (f,) = factors
    edges = jnp.asarray(f.indices['x'].numpy())
    z = jnp.asarray(f.consts.numpy())
    t = z.shape[-1]
    eye = jnp.eye(t, dtype=z.dtype)

    def residual(v, c):              # one edge: v['x'] [2, t]
        return v['x'][1] - v['x'][0] - c

    def bjac(v, c):
        J = jnp.broadcast_to(jnp.stack([-eye, eye], 1),
                             (c.shape[0], t, 2, t))
        return v['x'][:, 1] - v['x'][:, 0] - c, {'x': J}
    return jsp.SparseLM({'x': jnp.asarray(params['x'].numpy())},
                        [jsp.Factor(residual, {'x': edges}, z,
                                    batched_jacobian=bjac)],
                        strategy=JTrustRegion(radius=1e4),
                        fixed={'x': jnp.asarray(fixed['x'].numpy())},
                        cg_iter=100, cg_tol=1e-8)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_c3_ring3_matches_jax(dtype):
    """The C3 input (an arity-2 factor over a Euclidean [64, 3] group on
    stencil edges, t = 3): route 'stencil' in float32 (t = 3 has a
    template in the kernels; its plain version here) and 'einsum'
    in float64, the plain stencil CG in the JAX package."""
    params, factors, fixed = ring3_problem(dtype=getattr(torch, dtype),
                                           device='cpu')
    topt = tsp.SparseLM(params, factors, strategy=TrustRegion(radius=1e4),
                        fixed=fixed, cg_iter=100, cg_tol=1e-8)
    assert topt.route == ('stencil' if dtype == 'float32' else 'einsum')
    assert topt._stencil_all is not None
    with jax.enable_x64(dtype == 'float64'):
        jopt = jax_ring3(params, factors, fixed)
        jhist = [jopt.step() for _ in range(3)]
        jx = np.asarray(jopt.params['x'])
    thist = [topt.step() for _ in range(3)]
    f32 = dtype == 'float32'
    np.testing.assert_allclose(thist, jhist, rtol=1e-4 if f32 else 1e-10)
    np.testing.assert_allclose(topt.params['x'].numpy(), jx,
                               atol=1e-5 if f32 else 1e-10)


def test_route_predicate():
    """'stencil' for one merged stencil, block-Jacobi and float32, at any
    block size t (3 and 5 here: t = 5 takes the kernels' runtime-t
    instantiation on the card); 'chain' for the chain preconditioner;
    'einsum' otherwise (float64 here, at t = 3 and 5)."""
    def sphere(dtype, **kw):
        return pgo_optimizer(synthetic_sphere(100, dtype=dtype,
                                              device='cpu'),
                             radius=1e4, cg_iter=10, cg_tol=1e-6, **kw)
    assert sphere(torch.float32).route == 'stencil'
    assert sphere(torch.float64).route == 'einsum'
    opt = sphere(torch.float32)
    assert tsp.SparseLM(opt.params, opt.factors,
                        precond='chain').route == 'chain'
    assert opt._spmv is None          # the stencil route builds none
    params, factors, fixed = ring3_problem(device='cpu')
    assert tsp.SparseLM(params, factors).route == 'stencil'
    params, factors, fixed = ring3_problem(device='cpu', t=5)
    assert tsp.SparseLM(params, factors).route == 'stencil'
    for t in (3, 5):
        params, factors, fixed = ring3_problem(device='cpu', t=t,
                                               dtype=torch.float64)
        assert tsp.SparseLM(params, factors).route == 'einsum'
    chain = pgo_optimizer(chain_instance(torch.float32), **CHAIN)
    assert chain.route == chain.precond == 'chain'


def dense_first_solve(opt, damping):
    """x of ``opt``'s first LM solve at ``damping`` by numpy's dense solve
    of the damped normal equations, assembled edge by edge from the
    port's Jacobian blocks (diagonal clamped to [min, max], then damped;
    fixed nodes removed)."""
    nm = opt._spmv_name
    N = opt.params[nm].shape[0]
    blocks = [opt._weighted(f, *opt._edge_r_jac(opt.params, f, fi))
              for fi, f in enumerate(opt.factors)]
    t = blocks[0][1][nm].shape[-1]
    A, g = np.zeros((N, t, N, t)), np.zeros((N, t))
    for f, (r, J, WR, WJ) in zip(opt.factors, blocks):
        idx = f.indices[nm].numpy()
        Jn, WJn, rn = J[nm].numpy(), WJ[nm].numpy(), r.numpy()
        for a in range(2):
            np.add.at(g, idx[:, a], -np.einsum('edt,ed->et', WJn[:, :, a], rn))
            for c in range(2):
                np.add.at(A, (idx[:, a], slice(None), idx[:, c], slice(None)),
                          np.einsum('edt,edu->etu', WJn[:, :, a], Jn[:, :, c]))
    A = A.reshape(N * t, N * t)
    diag_raw = np.diag(A).copy()
    diagA = np.clip(diag_raw, opt.min, opt.max)
    A[np.diag_indices_from(A)] += diagA - diag_raw + damping * diagA
    keep = np.repeat(~opt.fixed[nm].numpy(), t)
    x = np.zeros(N * t)
    x[keep] = np.linalg.solve(A[np.ix_(keep, keep)], g.reshape(-1)[keep])
    return x.reshape(N, t), blocks


@pytest.mark.parametrize('case', ['chain', 'loops', 'sphere'])
def test_first_solve_matches_dense_f64(case):
    """The einsum CG of the 'chain' route (BCR), of the 'einsum' route
    through CouplingSpMV (pgo_loops_instance(200)) and through the
    per-factor stencils (synthetic_sphere(100), the C2 input), float64,
    against the dense solve of the same system: within 1e-8 of its
    largest entry."""
    ds = {'chain': lambda: chain_instance(torch.float64),
          'loops': lambda: pgo_loops_instance(200, dtype=torch.float64,
                                              device='cpu'),
          'sphere': lambda: synthetic_sphere(100, dtype=torch.float64,
                                             device='cpu')}[case]()
    opt = pgo_optimizer(ds, radius=1e4, cg_iter=2000, cg_tol=1e-13,
                        split_chains=case != 'loops')
    assert opt.route == ('chain' if case == 'chain' else 'einsum')
    damping = 1e-3
    x_ref, blocks = dense_first_solve(opt, damping)
    b, diag_raw = opt._rhs(blocks), opt._diag(blocks)
    accum = opt._block_diag_accum(blocks)
    diagA = {n: torch.clamp(v, opt.min, opt.max) for n, v in diag_raw.items()}
    x, it = opt._einsum_solver(b, diagA, diag_raw, accum, blocks,
                               opt.cg_iter)(damping)
    assert 0 < it < opt.cg_iter
    scale = np.abs(x_ref).max()
    np.testing.assert_allclose(x[opt._spmv_name].numpy(), x_ref, rtol=0,
                               atol=1e-8 * scale)


@pytest.mark.parametrize('name', ['Constant', 'Adaptive', 'Adaptive-1e-2'])
def test_sparse_lm_strategies_match_jax_f64(name):
    """SparseLM with Constant(1e-6) and Adaptive() (the JAX package's
    ``_strategy_update``, ``pypose_tpu/optim/sparse.py:851-870``) on
    pgo_loops_instance(100) in float64: three step() calls from the same
    numpy params and strategy state; chi2 and the damping within 1e-9
    relative.  Adaptive() starts at its floor (1e-6) and stays there on
    good steps; Adaptive(damping=1e-2) halves it each good step."""
    from pypose_tpu.optim import strategy as jstrategy
    from pypose_tpu_torch.optim import strategy as tstrategy
    from pypose_tpu_torch.testing import (params_from_numpy,
                                          strategy_state_from_numpy)
    make = {'Constant': lambda m: m.Constant(1e-6),
            'Adaptive': lambda m: m.Adaptive(),
            'Adaptive-1e-2': lambda m: m.Adaptive(damping=1e-2)}[name]
    ds = pgo_loops_instance(100, dtype=torch.float64, device='cpu')
    nodes = ds['nodes'].tensor().numpy()
    sched = dict(radius=1e4, cg_iter=100, cg_tol=1e-10, split_chains=False)
    with jax.enable_x64(True):
        jopt = jax_pgo(ds, **sched)
        jopt.strategy = make(jstrategy)
        jopt.params = {'poses': JSE3(jnp.asarray(nodes))}
        jopt.strategy_state = jopt.strategy.init(jnp.float64)
        state0 = {k: np.asarray(v) for k, v in jopt.strategy_state.items()}
        jhist, jdamp = [], []
        for _ in range(3):
            jhist.append(jopt.step())
            jdamp.append(float(jopt.strategy_state['damping']))
    topt = pgo_optimizer(ds, **sched, strategy=make(tstrategy))
    assert topt.route == 'einsum'
    topt.params = params_from_numpy({'poses': nodes}, {'poses': 'SE3'})
    topt.strategy_state = strategy_state_from_numpy(state0)
    thist, tdamp = [], []
    for _ in range(3):
        thist.append(topt.step())
        tdamp.append(float(topt.strategy_state['damping']))
    np.testing.assert_allclose(thist, jhist, rtol=1e-9)
    np.testing.assert_allclose(tdamp, jdamp, rtol=1e-9)
    if name == 'Adaptive-1e-2':
        assert len(set(jdamp)) > 1, 'Adaptive never moved the damping'
