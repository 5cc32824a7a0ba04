"""The port's SparseLM on the oversize CG routes (graphs past the
whole-solve kernel's L2 budget: the fused solver, which stencil_cg takes,
and the tiled solver beside it) against the JAX package's SparseLM, and
stencil_cg's choice of route.  The route is forced at a small size by
patching ``stencil_cg_fits`` where ``stencil_cg`` reads it
(``pypose_tpu_torch.ops.stencil_cg``: SparseLM leaves the choice to
stencil_cg), and the tiled solver put in the fused solver's place for
the ``tiled`` case.  The real 100k-pose graph is in
test_torch_pgo100k_anchor.py.

Tolerances as in test_torch_sparse_lm.py: chi2 per step rtol 1e-3 in
float32 (CG to its 150-iteration cap, sums in another order) and 1e-8 in
float64.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pypose_tpu_torch.ops import stencil_cg as scg
from pypose_tpu_torch.ops.spmv import StencilSpMV

from test_torch_sparse_lm import jax_problem, torch_problem
from test_torch_stencil_cg import make_system
from pypose_tpu_torch.testing import cap_threads

cap_threads()


@pytest.fixture(params=['tiled', 'fused'])
def tiled_route(request, monkeypatch):
    """Every solve past the budget, on the fused solver or, for 'tiled',
    the tiled one; counts the calls of that route's and of the
    whole-solve plain versions (key 'tiled': the oversize route's)."""
    calls = {'tiled': 0, 'whole': 0}

    def spy(route, fn):
        def wrapped(*args):
            calls[route] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(scg, 'stencil_cg_fits', lambda *a: False)
    if request.param == 'tiled':
        monkeypatch.setattr(scg, 'stencil_cg_fused', scg.stencil_cg_tiled)
    plain = '_tiled_cg_torch' if request.param == 'tiled' \
        else '_fused_cg_torch'
    monkeypatch.setattr(scg, plain, spy('tiled', getattr(scg, plain)))
    monkeypatch.setattr(scg, '_cg_body_torch',
                        spy('whole', scg._cg_body_torch))
    return calls


def test_optimize_on_tiled_route_matches_jax_f32(tiled_route):
    """synthetic_sphere(300) from the JAX package, carried over as numpy:
    optimize(steps=4) on both sides, chi2 per step within rtol 1e-3."""
    ds, jopt = jax_problem(300, jnp.float32)
    topt = torch_problem(ds)
    jopt.optimize(steps=4)
    topt.optimize(steps=4)
    assert len(topt.history) == len(jopt.history) == 4
    np.testing.assert_allclose(topt.history, jopt.history, rtol=1e-3)
    assert tiled_route['whole'] == 0
    assert tiled_route['tiled'] == sum(len(s) for s in topt.cg_iterations)
    assert all(0 < i <= 150 for s in topt.cg_iterations for i in s)


def test_steps_on_tiled_route_match_jax_f64(tiled_route):
    """float64.  SparseLM routes float64 to the einsum CG (the stencil
    kernels take float32 only), so the oversize solvers' plain versions,
    which take float64, are held on the system SparseLM assembles for
    synthetic_sphere(300) from the JAX package: its normal equations at
    the initial poses, at two dampings, solved by the port's stencil
    solve (``SparseLM._stencil_solver``, stencil_cg on the fixture's
    route) and by the JAX package's stencil_cg(use_pallas=False) on the
    same arrays; x within rtol 1e-8 of the larger entries (atol 1e-10)."""
    from pypose_tpu.ops.pallas_cg import stencil_cg as jax_stencil_cg
    from pypose_tpu_torch.ops.smallinv import blockinv
    with jax.enable_x64(True):
        ds, _ = jax_problem(300, jnp.float64)
    topt = torch_problem(ds)
    assert topt.dtype == torch.float64 and topt.route == 'einsum'
    nm = topt._spmv_name
    blocks = [topt._weighted(f, *topt._edge_r_jac(topt.params, f, fi))
              for fi, f in enumerate(topt.factors)]
    b, diag_raw = topt._rhs(blocks), topt._diag(blocks)
    accum = topt._block_diag_accum(blocks)
    diagA = {n: torch.clamp(v, topt.min, topt.max)
             for n, v in diag_raw.items()}
    solve = topt._stencil_solver(b, diagA, diag_raw, accum, blocks,
                                 topt.cg_iter)
    C_all = topt._stencil_all.precompute_multi(
        [(blk[1][nm], blk[3][nm]) for blk in blocks])
    for damping in (1e-4, 1e-1):
        x, it = solve(damping)
        dcorr = diagA[nm] - diag_raw[nm] + damping * diagA[nm]
        Minv = blockinv(topt._damped_blocks(accum, {nm: 1.0 + damping})[nm])
        with jax.enable_x64(True):
            x_j, it_j = jax_stencil_cg(
                *(jnp.asarray(a.numpy()) for a in (b[nm], accum[nm], dcorr,
                                                   Minv, C_all)),
                tuple(topt._stencil_all.offsets),
                fixed_mask=jnp.asarray(topt.fixed[nm].numpy()),
                maxiter=topt.cg_iter, tol=topt.cg_tol, use_pallas=False)
            x_j = np.asarray(x_j)
        assert x[nm].dtype == torch.float64
        np.testing.assert_allclose(x[nm].numpy(), x_j,
                                   rtol=1e-8, atol=1e-10)
    assert tiled_route['tiled'] == 2 and tiled_route['whole'] == 0


@pytest.mark.parametrize('fits', [True, False])
def test_stencil_cg_picks_route_by_budget(monkeypatch, fits):
    """stencil_cg takes the whole-solve route exactly where
    stencil_cg_fits holds and the fused solver where it does not; either
    way x is within the existing stencil tests' 5e-3 of the dense solve
    (float32)."""
    seen = []
    monkeypatch.setattr(scg, 'stencil_cg_fits',
                        lambda *a: seen.append(a) or fits)
    for name in ('stencil_cg_transposed', 'stencil_cg_fused'):
        monkeypatch.setattr(scg, name, lambda *a, _fn=getattr(scg, name),
                            _n=name: seen.append(_n) or _fn(*a))
    edges, J, D, dcorr, Minv, b, A_dense = make_system(40, seed=3)
    sp = StencilSpMV(edges, 40, 6)
    x, it = scg.stencil_cg(
        torch.from_numpy(b), torch.from_numpy(D), torch.from_numpy(dcorr),
        torch.from_numpy(Minv),
        sp.precompute(torch.from_numpy(J), torch.from_numpy(J)),
        tuple(sp.offsets), maxiter=400, tol=1e-7)
    assert seen == [(40, 6, 2), 'stencil_cg_transposed' if fits
                    else 'stencil_cg_fused']
    x_ref = np.linalg.solve(A_dense, b.reshape(-1)).reshape(b.shape)
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=5e-3, atol=5e-4)
