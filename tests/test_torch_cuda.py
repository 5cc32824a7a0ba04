"""The port's CUDA kernels on an NVIDIA GPU (marked ``cuda``; each test
skips where torch has no CUDA device).  This file imports no jax, so it
runs on a machine without the JAX package:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

(``--noconftest`` because tests/conftest.py configures jax.)
"""

import pytest
import torch

from pypose_tpu_torch.ops import stencil_cg as scg
from pypose_tpu_torch.testing import random_stencil_system

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    return torch.device('cuda')


@pytest.mark.parametrize('N,loop_offset,fixed,maxiter,tol', [
    (40, 9, False, 500, 1e-6), (2500, 157, True, 500, 1e-6),
    (2500, 157, True, 150, 0.0)])
def test_kernel_matches_plain(cuda, N, loop_offset, fixed, maxiter, tol):
    """x within 1e-4 of max|x| (+1e-5) of the plain version on the same
    CUDA tensors, iterations within one, one launch counted."""
    gen = torch.Generator(device=cuda).manual_seed(N)
    offsets, ops = random_stencil_system(N, loop_offset, max(15, N * 4 // 5),
                                         fixed, gen, cuda)
    before = scg.LAUNCHES
    x_k, it_k = scg.stencil_cg_transposed(*ops, offsets, 6, maxiter, tol)
    torch.cuda.synchronize()
    assert scg.LAUNCHES == before + 1
    x_p, it_p = scg._cg_body_torch(ops[1], ops[2], ops[3], ops[0], offsets,
                                   6, maxiter, tol)
    err = float((x_k - x_p).abs().max())
    assert err <= 1e-4 * float(x_p.abs().max()) + 1e-5
    assert abs(int(it_k) - int(it_p)) <= 1
    # deterministic reductions: a second launch repeats bit for bit
    x_k2, it_k2 = scg.stencil_cg_transposed(*ops, offsets, 6, maxiter, tol)
    assert torch.equal(x_k, x_k2) and int(it_k) == int(it_k2)


@pytest.mark.parametrize('solver', ['tiled', 'fused'])
@pytest.mark.parametrize('N,loop_offset,n_loops,fixed,maxiter,tol', [
    (53, 9, 15, False, 200, 1e-7),
    (100_000, 993, 80_000, True, 250, 1e-3),
    (100_000, 993, 80_000, True, 250, 0.0)])
def test_oversize_solvers_match_plain(cuda, solver, N, loop_offset, n_loops,
                                      fixed, maxiter, tol):
    """The tiled and the fused solver against their plain versions on the
    same CUDA tensors (N=53 with wrapping offsets; the 100k shape,
    converged at tol 1e-3 and run to 250 iterations): x within 1e-4 of
    max|x| (+1e-5), iterations within one, kernels launched, and a second
    run repeats bit for bit (fixed-order reductions)."""
    gen = torch.Generator(device=cuda).manual_seed(N)
    offsets, ops = random_stencil_system(N, loop_offset, n_loops, fixed, gen,
                                         cuda)
    kernel, plain, counters = {
        'tiled': (scg.stencil_cg_tiled, scg._tiled_cg_torch,
                  ('TILED_MV_LAUNCHES', 'TILED_PC_LAUNCHES')),
        'fused': (scg.stencil_cg_fused, scg._fused_cg_torch,
                  ('FUSED_AXPY_LAUNCHES', 'FUSED_MV_LAUNCHES'))}[solver]
    before = [getattr(scg, c) for c in counters]
    x_k, it_k = kernel(*ops, offsets, 6, maxiter, tol)
    torch.cuda.synchronize()
    assert all(getattr(scg, c) > b for c, b in zip(counters, before))
    x_p, it_p = plain(ops[1], ops[2], ops[3], ops[0], offsets, 6, maxiter,
                      tol)
    err = float((x_k - x_p).abs().max())
    assert err <= 1e-4 * float(x_p.abs().max()) + 1e-5
    assert abs(int(it_k) - int(it_p)) <= 1
    x_k2, it_k2 = kernel(*ops, offsets, 6, maxiter, tol)
    assert torch.equal(x_k, x_k2) and int(it_k) == int(it_k2)


def test_tiled_kernels_match_plain(cuda):
    """One launch of the tiled matvec and block-Jacobi kernels at the 100k
    shape against the plain versions: within 1e-5 of max|y| (+1e-6)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    offsets, (b_T, A_T, Minv_T, C_T) = random_stencil_system(
        100_000, 993, 80_000, True, gen, cuda)
    v = torch.randn(b_T.shape, generator=gen, device=cuda)
    for y_k, y_p in (
            (scg._tiled_mv_launch(A_T, C_T, v, offsets, 6),
             scg._stencil_matvec_torch(A_T, C_T, offsets, 6, v)),
            (scg._tiled_pc_launch(Minv_T, v, 6),
             scg._block_mul(Minv_T, v, 6))):
        err = float((y_k - y_p).abs().max())
        assert err <= 1e-5 * float(y_p.abs().max()) + 1e-6


def test_wrapper_refusals_on_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    offsets, ops = random_stencil_system(40, 9, 15, False, gen, cuda)
    for solver in (scg.stencil_cg_transposed, scg.stencil_cg_tiled,
                   scg.stencil_cg_fused):
        with pytest.raises(TypeError, match='float32'):
            solver(*(o.double() for o in ops), offsets, 6, 5, 1e-6)
    b_T = ops[0]
    strided = torch.empty((6, 80), device=cuda)[:, ::2]
    strided.copy_(b_T)
    with pytest.raises(ValueError, match='contiguous'):
        scg.stencil_cg_transposed(strided, *ops[1:], offsets, 6, 5, 1e-6)


def test_first_lm_step_card_matches_cpu(cuda):
    """One LM step of sphere2500 (the vendored problem, phase-1 settings)
    on the card and on the CPU: chi2 within 1e-3 relative (float32; the
    CG runs to its 150-iteration cap with sums in another order)."""
    from pypose_tpu_torch.datasets import find_data, load_g2o
    from pypose_tpu_torch.optim.sparse import (SparseLM, pgo_factor,
                                               split_chain_edges)
    from pypose_tpu_torch.optim.strategy import TrustRegion

    chi2 = []
    for dev in (cuda, torch.device('cpu')):
        ds = load_g2o(find_data('synthetic_sphere2500_seed42.g2o'),
                      device=dev)
        edges = ds['edges']
        runs, rest = split_chain_edges(edges)
        factors = []
        for rows in list(runs) + [rest]:
            rows = torch.as_tensor(rows, device=dev)
            factors.append(pgo_factor(edges[rows], ds['poses'][rows]))
        fixed = torch.zeros(ds['nodes'].shape[0], dtype=torch.bool,
                            device=dev)
        fixed[0] = True
        before = scg.LAUNCHES
        opt = SparseLM({'poses': ds['nodes']}, factors,
                       strategy=TrustRegion(radius=1e4),
                       fixed={'poses': fixed}, cg_iter=150, cg_tol=1e-9)
        chi2.append(opt.step())
        assert (scg.LAUNCHES > before) == (dev.type == 'cuda')
    assert abs(chi2[0] - chi2[1]) <= 1e-3 * abs(chi2[1])
    assert not torch.backends.cuda.matmul.allow_tf32
