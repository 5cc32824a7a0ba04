"""The port's CUDA kernels on an NVIDIA GPU (marked ``cuda``; each test
skips where torch has no CUDA device): the stencil CG solvers, the
nearest-neighbour and SE3 kernels against their plain versions, the paths
through them, and the general SparseLM routes (no kernel) card against
CPU.  This file imports no jax, so it
runs on a machine without the JAX package:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

(``--noconftest`` because tests/conftest.py configures jax.)
"""

import pytest
import torch

from pypose_tpu_torch.lietensor.operation import FUNCTIONS
from pypose_tpu_torch.ops import knn, se3, stencil_cg as scg
from pypose_tpu_torch.testing import (nn1_tolerance_failures,
                                      nnk_tolerance_failures,
                                      random_stencil_system)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernel has no CPU mode)')
    return torch.device('cuda')


@pytest.mark.parametrize('N,loop_offset,fixed,maxiter,tol', [
    (40, 9, False, 500, 1e-6), (2500, 157, True, 500, 1e-6),
    (2500, 157, True, 150, 0.0), (2501, 157, True, 500, 1e-6),
    (20_000, 157, True, 500, 1e-6)])
def test_kernel_matches_plain(cuda, N, loop_offset, fixed, maxiter, tol):
    """x within 1e-4 of max|x| (+1e-5) of the plain version on the same
    CUDA tensors, iterations within one, one launch counted: the cluster
    kernel at N=40 (most CTAs own 2-3 nodes), the sphere2500 shape
    (converged, and to 150 iterations), an N not divisible by the cluster
    size, and N=20,000, where the operands stay in L2."""
    assert scg.stencil_cg_smem_fits(N, 6, 2) == (N <= 2501)
    assert scg.stencil_cg_fits(N, 6, 2)
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


@pytest.mark.parametrize('solver', ['tiled', 'fused', 'fused_bf16'])
@pytest.mark.parametrize('N,loop_offset,n_loops,fixed,maxiter,tol', [
    (53, 9, 15, False, 200, 1e-7),
    (100_000, 993, 80_000, True, 250, 1e-3),
    (100_000, 993, 80_000, True, 250, 0.0),
    (200_000, 993, 160_000, True, 250, 1e-3)])
def test_oversize_solvers_match_plain(cuda, solver, N, loop_offset, n_loops,
                                      fixed, maxiter, tol):
    """The tiled and the fused solver (float32 and bf16 operands) against
    their plain versions on the same CUDA tensors (bf16: the same rounded
    operands, widened; N=53 with wrapping offsets; the 100k shape,
    converged at tol 1e-3 and run to 250 iterations, with the fused
    kernel's state in shared memory; N=200,000, past that mode): x within
    1e-4 of max|x| (+1e-5), iterations within one, kernels launched (the
    fused kernel once a solve), and a second run repeats bit for bit
    (fixed-order reductions)."""
    gen = torch.Generator(device=cuda).manual_seed(N)
    offsets, (b_T, *ops) = random_stencil_system(N, loop_offset, n_loops,
                                                 fixed, gen, cuda)
    if solver == 'tiled':
        counters = ('TILED_MV_LAUNCHES', 'TILED_PC_LAUNCHES')
        plain = scg._tiled_cg_torch

        def kernel():
            return scg.stencil_cg_tiled(b_T, *ops, offsets, 6, maxiter, tol)
    else:
        counters = ('FUSED_LAUNCHES',)
        plain = scg._fused_cg_torch
        dtype = torch.bfloat16 if solver == 'fused_bf16' else None
        ops = scg.round_operands(*ops, dtype)
        assert scg.fused_plan(N, 6, cuda)['smem'] == (N <= 100_000)

        def kernel():
            return scg.stencil_cg_fused(b_T, *ops, offsets, 6, maxiter, tol,
                                        operand_dtype=dtype)
    before = [getattr(scg, c) for c in counters]
    x_k, it_k = kernel()
    torch.cuda.synchronize()
    launched = [getattr(scg, c) - b for c, b in zip(counters, before)]
    assert launched == [1] if solver != 'tiled' else min(launched) > 0
    x_p, it_p = plain(*(a.float() for a in ops), b_T, offsets, 6, maxiter,
                      tol)
    err = float((x_k - x_p).abs().max())
    assert err <= 1e-4 * float(x_p.abs().max()) + 1e-5
    assert abs(int(it_k) - int(it_p)) <= 1
    x_k2, it_k2 = kernel()
    assert torch.equal(x_k, x_k2) and int(it_k) == int(it_k2)


def test_stencil_cg_routes_oversize_to_fused(cuda):
    """stencil_cg past the whole-solve budget: one fused launch, no tiled
    or whole-solve launch."""
    from pypose_tpu_torch.ops.smallinv import blockinv
    from pypose_tpu_torch.ops.spmv import StencilSpMV
    N = 100_000
    gen = torch.Generator(device=cuda).manual_seed(4)
    ar = torch.arange(N, device=cuda)
    edges = torch.cat([torch.stack([ar[:-1], ar[1:]], 1),
                       torch.stack([ar[:-993], ar[993:]], 1)])
    J = torch.randn((edges.shape[0], 6, 2, 6), generator=gen, device=cuda)
    sp = StencilSpMV(edges, N, 6, device=cuda)
    D = torch.zeros((N, 6, 6), device=cuda)
    for a in range(2):
        D.index_add_(0, edges[:, a],
                     torch.einsum('edt,edu->etu', J[:, :, a], J[:, :, a]))
    dcorr = 0.1 * torch.diagonal(D, dim1=-2, dim2=-1)
    Minv = blockinv(D + torch.diag_embed(dcorr))
    b = torch.randn((N, 6), generator=gen, device=cuda)
    before = (scg.FUSED_LAUNCHES, scg.TILED_MV_LAUNCHES, scg.LAUNCHES)
    assert not scg.stencil_cg_fits(N, 6, len(sp.offsets))
    x, it = scg.stencil_cg(b, D, dcorr, Minv, sp.precompute(J, J),
                           tuple(sp.offsets), maxiter=50, tol=1e-3)
    torch.cuda.synchronize()
    assert (scg.FUSED_LAUNCHES - before[0], scg.TILED_MV_LAUNCHES - before[1],
            scg.LAUNCHES - before[2]) == (1, 0, 0)
    assert bool(torch.isfinite(x).all()) and 0 < int(it) <= 50


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


def _clouds(R, N, dev, seed=0, D=3):
    gen = torch.Generator().manual_seed(seed)
    return ((5.0 * torch.randn((R, D), generator=gen)).to(dev),
            (5.0 * torch.randn((N, D), generator=gen)).to(dev))


def _assert_nnk_within_tolerance(ref, nbr, d_k, i_k, i_p):
    """The rule of pypose_tpu_torch.testing.nnk_tolerance_failures: each
    index equal to the plain one or a near-tie, distinct within its row,
    each d2 within 1e-6 (|a|^2 + |b|^2) + 1e-6 of its pair's float64
    d2."""
    got = nnk_tolerance_failures(ref, nbr, d_k, i_k, i_p)
    assert got['index_failures'] == got['repeat_failures'] == 0, got
    assert got['d2_failures'] == 0, got
    assert i_k.dtype == torch.int64


def _assert_nn1_within_tolerance(ref, nbr, d_k, i_k, i_p):
    """The nn1 rule of pypose_tpu_torch.testing.nn1_tolerance_failures:
    each index equal to the plain one or a near-tie, each d2 within
    1e-6 (|a|^2 + |b|^2) + 1e-6 of its pair's float64 d2."""
    got = nn1_tolerance_failures(ref, nbr, d_k, i_k, i_p)
    assert got['index_failures'] == 0 and got['d2_failures'] == 0, got
    assert i_k.dtype == torch.int64


@pytest.mark.parametrize('R,N,D', [(333, 777, 3), (1, 5, 3),
                                   (100_000, 100_000, 3), (300, 2000, 1),
                                   (300, 2000, 2), (300, 2000, 4)])
def test_nn1_kernel_matches_plain(cuda, R, N, D):
    ref, nbr = _clouds(R, N, cuda, D=D)
    before = knn.NN1_LAUNCHES
    d_k, i_k = knn.nn1(ref, nbr)
    torch.cuda.synchronize()
    assert knn.NN1_LAUNCHES == before + 1
    _assert_nn1_within_tolerance(ref, nbr, d_k, i_k,
                                 knn._nn1_torch(ref, nbr)[1])


def test_nn1_kernel_on_duplicated_points(cuda):
    """Neighbours that repeat (every point twice, and a copy of some
    reference rows): the first index among exact ties, as the plain
    version takes it, and the tolerance rule everywhere."""
    ref, base = _clouds(50_000, 50_000, cuda, seed=3)
    nbr = torch.cat([base, base, ref[:1000]])
    d_k, i_k = knn.nn1(ref, nbr)
    i_p = knn._nn1_torch(ref, nbr)[1]
    _assert_nn1_within_tolerance(ref, nbr, d_k, i_k, i_p)
    # an exact duplicate never wins over the copy at the lower index
    assert not bool(((i_k >= 50_000) & (i_k < 100_000)).any())


@pytest.mark.parametrize('R,N,k', [(150, 333, 2), (150, 333, 7),
                                   (150, 333, 16), (40, 16, 16),
                                   (20_000, 100_000, 4),
                                   (20_000, 100_000, 16)])
def test_nnk_kernel_matches_plain(cuda, R, N, k):
    ref, nbr = _clouds(R, N, cuda, seed=k)
    before = knn.NNK_LAUNCHES
    d_k, i_k = knn.nnk(ref, nbr, k)
    torch.cuda.synchronize()
    assert knn.NNK_LAUNCHES == before + 1
    assert d_k.shape == i_k.shape == (R, k)
    _assert_nnk_within_tolerance(ref, nbr, d_k, i_k,
                                 knn._nnk_torch(ref, nbr, k)[1])


def test_knn_kernel_ties_and_refusals(cuda):
    """Duplicated neighbours: the lower index first; k above the kernel's
    largest, points of more than 8 coordinates, float16 clouds and
    clouds of two dtypes raise."""
    base = _clouds(1, 200, cuda)[1]
    nbr = torch.cat([base, base[:50]])
    d2, idx = knn.nnk(base[:50] + 1e-3, nbr, 2)
    assert torch.equal(idx[:, 0].cpu(), torch.arange(50))
    assert torch.equal(idx[:, 1].cpu(), 200 + torch.arange(50))
    with pytest.raises(ValueError, match='k=17'):
        knn.nnk(base, base, knn.MAX_K + 1)
    with pytest.raises(ValueError, match='coordinates'):
        knn.nn1(torch.zeros((4, 9), device=cuda),
                torch.zeros((6, 9), device=cuda))
    with pytest.raises(TypeError, match='float32'):
        knn.nn1(base.half(), base.half())
    with pytest.raises(TypeError, match='float32'):
        knn.nnk(base, base.double(), 2)


@pytest.mark.parametrize('D', [5, 6, 7, 8])
def test_wide_point_kernels_match_plain(cuda, D):
    """nn1 and nnk (k = 2, 8, 16) on points of 5 to 8 coordinates, one
    launch each, under the near-tie rules."""
    ref, nbr = _clouds(3000, 20_000, cuda, seed=D, D=D)
    before = knn.NN1_LAUNCHES
    d_k, i_k = knn.nn1(ref, nbr)
    torch.cuda.synchronize()
    assert knn.NN1_LAUNCHES == before + 1
    _assert_nn1_within_tolerance(ref, nbr, d_k, i_k,
                                 knn._nn1_torch(ref, nbr)[1])
    for k in (2, 8, 16):
        before = knn.NNK_LAUNCHES
        d_k, i_k = knn.nnk(ref, nbr, k)
        torch.cuda.synchronize()
        assert knn.NNK_LAUNCHES == before + 1
        _assert_nnk_within_tolerance(ref, nbr, d_k, i_k,
                                     knn._nnk_torch(ref, nbr, k)[1])


# The float64 instantiations' rule: nnk_tolerance_failures at rtol = atol
# = 1e-13 (~450 float64 ulps of |a|^2 + |b|^2).
F64_TOL = dict(rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize('D', [3, 8])
def test_float64_kernels_match_plain(cuda, D):
    """nn1 and nnk (k = 2, 8, 16) on float64 clouds, one launch each,
    under the near-tie rules at F64_TOL."""
    ref, nbr = (a.double() for a in _clouds(3000, 20_000, cuda, seed=D, D=D))
    for k in (1, 2, 8, 16):
        name = 'NN1_LAUNCHES' if k == 1 else 'NNK_LAUNCHES'
        before = getattr(knn, name)
        d_k, i_k = knn.nnk(ref, nbr, k)
        torch.cuda.synchronize()
        assert getattr(knn, name) == before + 1
        assert d_k.dtype == torch.float64 and d_k.shape == (3000, k)
        got = nnk_tolerance_failures(ref, nbr, d_k, i_k,
                                     knn._nnk_torch(ref, nbr, k)[1],
                                     **F64_TOL)
        assert got['index_failures'] == got['repeat_failures'] == \
            got['d2_failures'] == 0, got


@pytest.mark.parametrize('k', [1, 8])
def test_knn_float64_launches_kernels(cuda, k):
    """float64 clouds past 64 Mi pairs launch the kernels' float64
    instantiation through knn, held to the near-tie rule at F64_TOL
    against the CPU's result; D = 9 raises on the card."""
    from pypose_tpu_torch.function.geometry import knn as knn_fn
    ref, nbr = (a.double() for a in _clouds(9000, 9000, cuda, seed=6, D=6))
    before = (knn.NN1_LAUNCHES, knn.NNK_LAUNCHES)
    res = knn_fn(ref, nbr, k=k)
    torch.cuda.synchronize()
    assert (knn.NN1_LAUNCHES, knn.NNK_LAUNCHES) == \
        (before[0] + (k == 1), before[1] + (k > 1))
    assert res.values.dtype == torch.float64
    cpu = knn_fn(ref.cpu(), nbr.cpu(), k=k)
    got = nnk_tolerance_failures(ref, nbr, res.values ** 2, res.indices,
                                 cpu.indices.to(cuda), **F64_TOL)
    assert got['index_failures'] == got['repeat_failures'] == \
        got['d2_failures'] == 0, got
    with pytest.raises(ValueError, match='coordinates'):
        knn_fn(*_clouds(9000, 9000, cuda, D=9), k=k)


def _steps_card_and_cpu(make, steps, route='einsum'):
    """chi2 of ``steps`` step() calls of ``make(device)``'s optimizer on
    the card and on the CPU: on the 'einsum' route with no stencil kernel
    launched, on the 'stencil' route with the whole-solve kernel launched
    on the card (once a solve) and nowhere else."""
    out = []
    for dev in ('cuda', 'cpu'):
        before = (scg.LAUNCHES, scg.FUSED_LAUNCHES)
        opt = make(dev)
        assert opt.route == route
        out.append([opt.step() for _ in range(steps)])
        whole = steps if (route, dev) == ('stencil', 'cuda') else 0
        assert scg.LAUNCHES - before[0] >= whole
        assert (scg.LAUNCHES - before[0] > 0) == (whole > 0)
        assert scg.FUSED_LAUNCHES == before[1]
    return out


def test_sparse_lm_float64_card_matches_cpu(cuda):
    """The C2 input, synthetic_sphere(100) in float64 on the card: the
    'einsum' route, chi2 within 1e-8 of the CPU's."""
    from pypose_tpu_torch.datasets import synthetic_sphere
    from pypose_tpu_torch.testing import pgo_optimizer
    card, cpu = _steps_card_and_cpu(lambda d: pgo_optimizer(
        synthetic_sphere(100, dtype=torch.float64, device=d), radius=1e4,
        cg_iter=150, cg_tol=1e-9), 3)
    assert max(abs(a / b - 1) for a, b in zip(card, cpu)) <= 1e-8


def test_ring3_card_matches_cpu(cuda):
    """The C3 input, a Euclidean [64, 3] factor on stencil edges (t = 3):
    the 'stencil' route through the whole-solve kernel at t = 3, chi2
    within 1e-4 of the CPU's; the same graph at t = 5 takes 'einsum'."""
    from pypose_tpu_torch.optim.sparse import SparseLM
    from pypose_tpu_torch.optim.strategy import TrustRegion
    from pypose_tpu_torch.testing import ring3_problem

    def make(dev):
        params, factors, fixed = ring3_problem(device=dev)
        return SparseLM(params, factors, strategy=TrustRegion(radius=1e4),
                        fixed=fixed, cg_iter=100, cg_tol=1e-8)
    card, cpu = _steps_card_and_cpu(make, 2, route='stencil')
    assert max(abs(a / b - 1) for a, b in zip(card, cpu)) <= 1e-4

    def make5(dev):
        params, factors, fixed = ring3_problem(device=dev, t=5)
        return SparseLM(params, factors, strategy=TrustRegion(radius=1e4),
                        fixed=fixed, cg_iter=100, cg_tol=1e-8)
    card, cpu = _steps_card_and_cpu(make5, 2)
    assert max(abs(a / b - 1) for a, b in zip(card, cpu)) <= 1e-4


def test_general_route_ops_card_match_cpu(cuda):
    """CouplingSpMV.couple, bcr_solve and the tree CG on the card against
    the same calls on the CPU (float32; rtol 1e-5 / 1e-4)."""
    from pypose_tpu_torch.ops.block_tridiag import bcr_factor, bcr_solve
    from pypose_tpu_torch.ops.spmv import CouplingSpMV
    from pypose_tpu_torch.optim.solver import cg
    gen = torch.Generator().manual_seed(0)
    N, t = 1000, 6
    ii = torch.arange(N - 1)
    loops = torch.randint(0, N, (300, 2), generator=gen)
    loops = loops[(loops[:, 1] - loops[:, 0]).abs() > 1]
    edges = torch.cat([torch.stack([ii, ii + 1], 1), loops])
    J = torch.randn((edges.shape[0], 6, 2, t), generator=gen)
    x = torch.randn((N, t), generator=gen)
    A = torch.randn((N, t, t), generator=gen)
    D = A @ A.mT + 4 * t * torch.eye(t)
    U = 0.3 * torch.randn((N, t, t), generator=gen)
    L = torch.cat([torch.zeros(1, t, t), U[:-1].mT])
    out = {}
    for dev in ('cuda', 'cpu'):
        sp = CouplingSpMV(edges, N, t, device=dev)
        st = sp.precompute(J.to(dev), J.to(dev))
        y = sp.couple(st, x.to(dev))
        z = bcr_solve(bcr_factor(D.to(dev), L.to(dev), U.to(dev)), x.to(dev))
        Dd = D.to(dev)
        w, k = cg(lambda v: {'x': torch.einsum('ntu,nu->nt', Dd, v['x'])},
                  {'x': x.to(dev)}, tol=1e-6, maxiter=50)
        out[dev] = [a.cpu() for a in (y, z, w['x'])] + [k]
    for a, b in zip(out['cuda'][:3], out['cpu'][:3]):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-5)
    assert abs(out['cuda'][3] - out['cpu'][3]) <= 1
    assert not torch.backends.cuda.matmul.allow_tf32


def test_knn_above_64mi_pairs_launches_nn1(cuda):
    """knn on CUDA past 64 Mi pairs routes k = 1 to the nn1 kernel, and
    agrees with the CPU's chunked Gram route."""
    from pypose_tpu_torch.function.geometry import knn as knn_fn
    ref, nbr = _clouds(9000, 9000, cuda, seed=1)
    before = knn.NN1_LAUNCHES
    res = knn_fn(ref, nbr)
    torch.cuda.synchronize()
    assert knn.NN1_LAUNCHES == before + 1
    cpu = knn_fn(ref.cpu(), nbr.cpu())
    _assert_nn1_within_tolerance(ref, nbr, res.values[:, 0] ** 2,
                                 res.indices[:, 0], cpu.indices[:, 0].to(cuda))


def test_knn_k8_launches_nnk(cuda):
    """knn(k=8) on CUDA past 64 Mi pairs makes exactly one nnk launch and
    holds to the tolerance rule against the plain version."""
    from pypose_tpu_torch.function.geometry import knn as knn_fn
    ref, nbr = _clouds(9000, 9000, cuda, seed=8)
    before = (knn.NNK_LAUNCHES, knn.NN1_LAUNCHES)
    res = knn_fn(ref, nbr, k=8)
    torch.cuda.synchronize()
    assert (knn.NNK_LAUNCHES, knn.NN1_LAUNCHES) == (before[0] + 1, before[1])
    _assert_nnk_within_tolerance(ref, nbr, res.values ** 2, res.indices,
                                 knn._nnk_torch(ref, nbr, 8)[1])


@pytest.mark.parametrize('N', [1, 1000, 100_000, 100_003])
def test_se3_kernels_match_plain(cuda, N):
    """Within 1e-6 (1 + max|input|) of SE3_Mul / SE3_Act."""
    import pypose_tpu_torch as ppt
    from pypose_tpu_torch.lietensor import operation as op
    gen = torch.Generator().manual_seed(N)
    X = ppt.randn_SE3(N, sigma=2.0, generator=gen).tensor().to(cuda)
    Y = ppt.randn_SE3(N, sigma=2.0, generator=gen).tensor().to(cuda)
    p = (5.0 * torch.randn((N, 3), generator=gen)).to(cuda)
    before = (se3.SE3_MUL_LAUNCHES, se3.SE3_ACT_LAUNCHES)
    for kern, plain, other in ((se3.se3_mul_fused, op.SE3_Mul, Y),
                               (se3.se3_act_fused, op.SE3_Act, p)):
        err = float((kern(X, other) - plain(X, other)).abs().max())
        bound = 1e-6 * (1 + max(float(X.abs().max()),
                                float(other.abs().max())))
        assert err <= bound
    assert (se3.SE3_MUL_LAUNCHES, se3.SE3_ACT_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    with pytest.raises(TypeError, match='float32'):
        se3.se3_mul_fused(X.double(), Y.double())


def test_icp_card_matches_cpu(cuda):
    """ICP on one 9,000-point instance (the auto-tiled route) on the card
    and on the CPU: transforms within 1e-5, nn1 launched every sweep."""
    import pypose_tpu_torch as ppt
    src, _ = _clouds(9000, 1, 'cpu', seed=2)
    T = ppt.randn_SE3(sigma=(0.3, 0.05),
                      generator=torch.Generator().manual_seed(3))
    tgt = T.Act(src)
    est = []
    for dev in (cuda, torch.device('cpu')):
        icp = ppt.ICP(stepper=ppt.ReduceToBason(steps=8, patience=8,
                                                tol=1e-9))
        before = knn.NN1_LAUNCHES
        est.append(icp(src.to(dev), tgt.to(dev)).to('cpu'))
        launches = knn.NN1_LAUNCHES - before
        assert launches == (icp.stepper.steps + 1 if dev.type == 'cuda'
                            else 0)
    assert float((est[0].Inv() @ est[1]).Log().tensor().abs().max()) <= 1e-5
    assert float((est[0].Inv() @ T).Log().tensor().abs().max()) <= 1e-4


@pytest.mark.parametrize('t', [3, 4, 7])
@pytest.mark.parametrize('N,loop_offset,fixed,maxiter,tol', [
    (40, 9, False, 500, 1e-6), (2500, 157, True, 60, 0.0),
    (20_000, 157, True, 60, 0.0)])
def test_kernel_matches_plain_at_block_size(cuda, t, N, loop_offset, fixed,
                                            maxiter, tol):
    """The whole-solve kernel's t = 3, 4 and 7 instantiations as
    test_kernel_matches_plain holds t = 6: at the sphere2500 shape with
    t = 7 a CTA's 157 nodes make 1,099 rows for 1,024 threads (some
    threads own two rows).  The capped runs stop at 60 iterations: these
    systems converge by 1e-6 in ~30, so past ~120 iterations |r|^2
    underflows float32 and a tol of 0 stops kernel and plain version at
    different counts."""
    assert scg.stencil_cg_smem_fits(N, t, 2) == (N <= 2500)
    gen = torch.Generator(device=cuda).manual_seed(N + t)
    offsets, ops = random_stencil_system(N, loop_offset, max(15, N * 4 // 5),
                                         fixed, gen, cuda, t=t)
    before = scg.LAUNCHES
    x_k, it_k = scg.stencil_cg_transposed(*ops, offsets, t, maxiter, tol)
    torch.cuda.synchronize()
    assert scg.LAUNCHES == before + 1
    x_p, it_p = scg._cg_body_torch(ops[1], ops[2], ops[3], ops[0], offsets,
                                   t, maxiter, tol)
    err = float((x_k - x_p).abs().max())
    assert err <= 1e-4 * float(x_p.abs().max()) + 1e-5
    assert abs(int(it_k) - int(it_p)) <= 1
    x_k2, it_k2 = scg.stencil_cg_transposed(*ops, offsets, t, maxiter, tol)
    assert torch.equal(x_k, x_k2) and int(it_k) == int(it_k2)


@pytest.mark.parametrize('t', [3, 4, 7])
@pytest.mark.parametrize('solver', ['tiled', 'fused', 'fused_bf16'])
@pytest.mark.parametrize('N,loop_offset,n_loops,fixed,maxiter,tol', [
    (53, 9, 15, False, 200, 1e-7),
    (100_000, 993, 80_000, True, 250, 1e-3)])
def test_oversize_solvers_match_plain_at_block_size(
        cuda, t, solver, N, loop_offset, n_loops, fixed, maxiter, tol):
    """The tiled and fused solvers' t = 3, 4 and 7 instantiations as
    test_oversize_solvers_match_plain holds t = 6."""
    gen = torch.Generator(device=cuda).manual_seed(N + t)
    offsets, (b_T, *ops) = random_stencil_system(N, loop_offset, n_loops,
                                                 fixed, gen, cuda, t=t)
    if solver == 'tiled':
        plain = scg._tiled_cg_torch

        def kernel():
            return scg.stencil_cg_tiled(b_T, *ops, offsets, t, maxiter, tol)
    else:
        plain = scg._fused_cg_torch
        dtype = torch.bfloat16 if solver == 'fused_bf16' else None
        ops = scg.round_operands(*ops, dtype)

        def kernel():
            return scg.stencil_cg_fused(b_T, *ops, offsets, t, maxiter, tol,
                                        operand_dtype=dtype)
    before = (scg.FUSED_LAUNCHES, scg.TILED_MV_LAUNCHES)
    x_k, it_k = kernel()
    torch.cuda.synchronize()
    if solver == 'tiled':
        assert scg.TILED_MV_LAUNCHES > before[1]
    else:
        assert scg.FUSED_LAUNCHES == before[0] + 1
    x_p, it_p = plain(*(a.float() for a in ops), b_T, offsets, t, maxiter,
                      tol)
    err = float((x_k - x_p).abs().max())
    assert err <= 1e-4 * float(x_p.abs().max()) + 1e-5
    assert abs(int(it_k) - int(it_p)) <= 1
    x_k2, it_k2 = kernel()
    assert torch.equal(x_k, x_k2) and int(it_k) == int(it_k2)


@pytest.mark.parametrize('t,nodes_in_smem', [(3, 2147), (4, 1449), (6, 805),
                                             (7, 637)])
def test_fused_plan_takes_block_size(cuda, t, nodes_in_smem):
    """The fused kernel's shared-memory mode holds 6t + tt floats a node
    within 232,448 - 512 bytes a CTA: 2,147 nodes a CTA at t = 3, 1,449 at
    t = 4, 805 at t = 6 and 637 at t = 7; the 100k shape (758 nodes a CTA
    on 132 SMs) is within it at t <= 6 and in global-memory mode at
    t = 7; other block sizes are refused."""
    assert (232_448 - 512) // (4 * (6 * t + t * t)) == nodes_in_smem
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for N in (53, 100_000, 200_000):
        plan = scg.fused_plan(N, t, cuda)
        assert plan['nodes_per_cta'] == -(-N // min(sms, max(1, N // 8)))
        assert plan['smem'] == (plan['nodes_per_cta'] <= nodes_in_smem)
    with pytest.raises(RuntimeError, match='invalid argument'):
        scg.fused_plan(100, 5, cuda)


def test_other_block_sizes_raise_on_card(cuda):
    """t = 5: every wrapper raises on CUDA tensors (no fall to the plain
    version); the C entry points refuse it too."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    offsets, ops = random_stencil_system(40, 9, 15, False, gen, cuda, t=5)
    before = (scg.LAUNCHES, scg.FUSED_LAUNCHES, scg.TILED_MV_LAUNCHES)
    for solver in (scg.stencil_cg_transposed, scg.stencil_cg_tiled,
                   scg.stencil_cg_fused):
        with pytest.raises(ValueError, match='instantiated'):
            solver(*ops, offsets, 5, 5, 1e-6)
    with pytest.raises(RuntimeError, match='invalid argument'):
        scg._tiled_pc_launch(ops[2], ops[0], 5)
    assert (scg.LAUNCHES, scg.FUSED_LAUNCHES,
            scg.TILED_MV_LAUNCHES) == before


@pytest.mark.parametrize('group', ['SO3', 'RxSO3', 'Sim3'])
def test_group_sphere2500_routes_through_whole_solve(cuda, group):
    """sphere2500 over SO3, RxSO3 and Sim3: route 'stencil', one
    whole-solve launch a solve and no fused launch; the first LM step's
    chi2 within 1e-3 of the CPU's (float32, a 150-iteration cap)."""
    from pypose_tpu_torch.datasets import find_data, load_g2o
    from pypose_tpu_torch.testing import pgo_group_instance, pgo_optimizer
    chi2 = []
    for dev in (cuda, torch.device('cpu')):
        ds = pgo_group_instance(
            load_g2o(find_data('synthetic_sphere2500_seed42.g2o'),
                     device=dev), group, torch.Generator().manual_seed(7))
        opt = pgo_optimizer(ds, radius=1e4, cg_iter=150, cg_tol=1e-8)
        assert opt.route == 'stencil'
        before = (scg.LAUNCHES, scg.FUSED_LAUNCHES)
        chi2.append(opt.step())
        solves = len(opt.cg_iterations[0]) if dev.type == 'cuda' else 0
        assert scg.LAUNCHES - before[0] == solves
        assert scg.FUSED_LAUNCHES == before[1]
    assert abs(chi2[0] - chi2[1]) <= 1e-3 * abs(chi2[1])


@pytest.mark.parametrize('name', list(FUNCTIONS))
def test_autograd_functions_card_match_cpu(cuda, name):
    """Each of the 32 autograd Functions on the card against the CPU, both
    in float64, at a batch of 1,000: the forward, the VJP of a random
    cotangent and a torch.func.jvp within 1e-9 of 1 + max|CPU| (1e-8 for
    the Sim3 ops)."""
    import numpy as np
    from pypose_tpu_torch.lietensor import operation as op
    from pypose_tpu_torch.testing import autograd_inputs
    rng = np.random.default_rng(0)
    args, on_group = autograd_inputs(name, 1000, rng)
    fn = getattr(op, name)
    ct = torch.from_numpy(rng.normal(size=fn(*args).shape))
    tans = tuple(torch.from_numpy(rng.normal(size=a.shape)) for a in args)

    def evaluate(dev):
        x = [a.to(dev).detach().requires_grad_() for a in args]
        out = fn(*x)
        vjp = torch.autograd.grad(out, x, ct.to(dev))
        _, tan = torch.func.jvp(fn, tuple(a.to(dev) for a in args),
                                tuple(t.to(dev) for t in tans))
        return [out.detach(), *vjp, tan]
    bound = 1e-8 if name.split('_')[0] in ('Sim3', 'sim3') else 1e-9
    for got, want in zip(evaluate(cuda), evaluate('cpu')):
        err = float((got.cpu() - want).abs().max())
        assert err <= bound * (1 + float(want.abs().max()))


def test_autodiff_sparse_lm_step_card_matches_cpu(cuda):
    """A residual-only factor (Jacobian by autodiff) over a 200-node Sim3
    ring with random loops (no merged stencil: route 'einsum', no kernel):
    the first two LM steps' chi2 on the card within 1e-4 of the CPU's."""
    from pypose_tpu_torch.testing import (pgo_loops_instance, pgo_optimizer)
    chi2 = []
    for dev in (cuda, 'cpu'):
        ds = pgo_loops_instance(200, device=dev, group='Sim3')
        opt = pgo_optimizer(ds, radius=1e4, cg_iter=100, cg_tol=1e-8,
                            split_chains=False, autodiff=True)
        assert opt.route == 'einsum'
        chi2.append([opt.step(), opt.step()])
    for card, cpu in zip(*chi2):
        assert abs(card - cpu) <= 1e-4 * abs(cpu)


def test_residual_only_factor_routes_through_whole_solve(cuda):
    """A residual-only factor on a t = 6 stencil graph (sphere2500, with
    a Huber kernel): route 'stencil' and one whole-solve launch a solve,
    no other kernel."""
    from pypose_tpu_torch.datasets import find_data, load_g2o
    from pypose_tpu_torch.optim.kernel import Huber
    from pypose_tpu_torch.testing import pgo_optimizer
    ds = load_g2o(find_data('synthetic_sphere2500_seed42.g2o'), device=cuda)
    opt = pgo_optimizer(ds, radius=1e4, cg_iter=150, cg_tol=1e-9,
                        kernel=Huber(delta=5.0), autodiff=True)
    assert opt.route == 'stencil'
    assert all(f.batched_jacobian is None for f in opt.factors)
    before = (scg.LAUNCHES, scg.FUSED_LAUNCHES, scg.TILED_MV_LAUNCHES,
              scg.TILED_PC_LAUNCHES)
    for _ in range(2):
        opt.step()
        assert scg.LAUNCHES - before[0] == len(opt.cg_iterations[0])
        before = (scg.LAUNCHES,) + before[1:]
    assert (scg.FUSED_LAUNCHES, scg.TILED_MV_LAUNCHES,
            scg.TILED_PC_LAUNCHES) == before[1:]


# ---------------------------------------------------------------------------
# bundle adjustment (no kernel on its path: library products and torch ops)
# ---------------------------------------------------------------------------

def _ba_pair(cuda, C=48, P=2100, k=5, seed=3, dtype=torch.float32, **kw):
    """The same synthetic_bal problem and BundleAdjustment on the card and
    on the CPU."""
    from pypose_tpu_torch.datasets import synthetic_bal
    from pypose_tpu_torch.optim.ba import BundleAdjustment
    out = []
    for dev in (cuda, 'cpu'):
        ds = synthetic_bal(C, P, k, seed=seed, pose_noise=(0.1, 0.02),
                           point_noise=0.1, dtype=dtype, device=dev)
        out.append((ds, BundleAdjustment(
            ds['poses'], ds['points'], ds['cam_idx'], ds['pt_idx'],
            ds['pixels'], ds['cameras'], fix_first_pose=True, **kw)))
    return out


def test_bal_blocks_and_instance_card_match_cpu(cuda):
    """synthetic_bal gives the same bits on the card; bal_reproj_blocks on
    the card within 1e-6 of the CPU's (of each array's largest entry)."""
    from pypose_tpu_torch.lietensor.scalarized import bal_reproj_blocks
    (dg, g), (dc, c) = _ba_pair(cuda)
    for key in ('poses', 'points', 'pixels', 'cam_idx', 'pt_idx'):
        a, b = dg[key], dc[key]
        a, b = (a.tensor(), b.tensor()) if hasattr(a, 'tensor') else (a, b)
        assert torch.equal(a.cpu(), b), key
    T, X = g.poses.tensor(), g.points
    got = bal_reproj_blocks(T[g.cam_idx], X[g.pt_idx], g.cameras, g.pixels)
    want = bal_reproj_blocks(c.poses.tensor()[c.cam_idx], c.points[c.pt_idx],
                             c.cameras, c.pixels)
    for a, b in zip(got, want):
        assert float((a.cpu() - b).abs().max()) <= 1e-6 * float(
            b.abs().max())
    # BAL IO and the projections
    from pypose_tpu_torch.datasets import find_data, load_bal
    from pypose_tpu_torch.function import reprojerr
    path = find_data('realformat_excerpt_bal.txt')
    a, b = load_bal(path, device=cuda), load_bal(path, device='cpu')
    assert torch.equal(a['poses'].tensor().cpu(), b['poses'].tensor())
    assert torch.equal(a['pixels'].cpu(), b['pixels'])
    K = torch.tensor([[500., 0., 320.], [0., 500., 240.], [0., 0., 1.]])
    X = c.points[:, None] + torch.tensor([0., 0., 30.])
    err = reprojerr(X.to(cuda), X[..., :2].to(cuda), K.to(cuda),
                    reduction='norm')
    want = reprojerr(X, X[..., :2], K, reduction='norm')
    assert torch.allclose(err.cpu(), want, rtol=1e-6, atol=1e-4)


def test_ba_windowed_sums_deterministic_on_card(cuda):
    """The windowed camera sums repeat their bits over calls on the card
    and agree with the CPU's (2e-5); the windowed broadcast is exact."""
    (_, g), (_, c) = _ba_pair(cuda)
    assert g._cam_win is not None
    gen = torch.Generator().manual_seed(0)
    O = g.pixels.shape[0]
    for shape in ((O, 6), (O, 6, 6)):
        x = torch.randn(shape, generator=gen)
        first = g._acc_cams(g._obs_data(), x.to(cuda))
        for _ in range(3):
            assert torch.equal(first, g._acc_cams(g._obs_data(), x.to(cuda)))
        want = c._acc_cams(c._obs_data(), x)
        assert torch.allclose(first.cpu(), want, rtol=2e-5, atol=2e-5)
    xc = torch.randn((g.C, 6), generator=gen)
    assert torch.equal(g._bcast_cams(g._obs_data(), xc.to(cuda)).cpu(),
                       xc[c.cam_idx])


def test_ba_schur_gram_float32_on_card(cuda):
    """The dense Gram of bf16 operands returns float32 on the card, within
    2e-6 (of its diagonal's scale) of the float64 product of the same
    values."""
    from pypose_tpu_torch.optim.ba import schur_gram
    gen = torch.Generator().manual_seed(1)
    T1 = torch.randn((30_000, 6 * 40), generator=gen).to(torch.bfloat16)
    M = schur_gram(T1.to(cuda))
    assert M.dtype == torch.float32 and M.device.type == 'cuda'
    exact = T1.double().T @ T1.double()
    scale = torch.sqrt(torch.diagonal(exact)[:, None]
                       * torch.diagonal(exact)[None, :])
    assert float(((M.cpu().double() - exact).abs() / scale).max()) <= 2e-6


@pytest.mark.parametrize('schur', ['dense', 'cg'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_ba_steps_card_match_cpu(cuda, schur, dtype):
    """Three LM steps on the card against the CPU's: float32 within 1e-5
    (Schur-CG: the third, converged step; the first two within 1e-3),
    float64 within 1e-9 (Schur-CG) or 1e-6 (dense, whose Gram runs on
    bf16 operands).  A truncated float32 CG's first step moves with its
    iteration count (measured on the CPU: 866.387 at 21 iterations,
    866.410 at 26, 883.051 at 40), and the iteration at which it meets
    its tolerance may differ by one between devices; run to a cap past
    float32's reach, its iterates wander (a first step 8e-4 apart)."""
    tol_cg = 1e-6 if dtype == torch.float32 else 1e-10
    (_, g), (_, c) = _ba_pair(cuda, 16, 600, 4, 1, dtype, schur=schur,
                              cg_iter=60, cg_tol=tol_cg)
    got = [g.step() for _ in range(3)]
    want = [c.step() for _ in range(3)]
    tol = 1e-5 if dtype == torch.float32 else (
        1e-6 if schur == 'dense' else 1e-9)
    early = 1e-3 if (dtype, schur) == (torch.float32, 'cg') else tol
    for i, (a, b) in enumerate(zip(got, want)):
        assert abs(a - b) <= (tol if i == 2 else early) * abs(b), (got, want)


def test_ba_non_pd_factor_rejects_on_card(cuda):
    """No boost, no gauge, damping 1e-12: the factor fails, the step is
    not taken, and nothing raises."""
    from pypose_tpu_torch.datasets import synthetic_bal
    from pypose_tpu_torch.optim.ba import BundleAdjustment
    from pypose_tpu_torch.optim.strategy import Constant
    ds = synthetic_bal(6, 100, 3, seed=3, device=cuda)
    ba = BundleAdjustment(ds['poses'], ds['points'], ds['cam_idx'],
                          ds['pt_idx'], ds['pixels'], ds['cameras'],
                          schur='dense', schur_refine=0,
                          strategy=Constant(1e-12))
    loss = ba.step()
    assert loss == ba.last and ba.reject_count == 0
    assert torch.equal(ba.points, ds['points'])


def test_ba_segment_sum_fallbacks_on_card(cuda, monkeypatch):
    """Past the degree caps the camera and point sums are segment sums:
    on the card they repeat their bits and agree with the CPU's (1e-5)."""
    from pypose_tpu_torch.optim.ba import BundleAdjustment
    monkeypatch.setattr(BundleAdjustment, 'MAX_POINT_DEGREE', 2)
    monkeypatch.setattr(BundleAdjustment, 'MAX_CAM_DEGREE', 2)
    (_, g), (_, c) = _ba_pair(cuda, 8, 300, 4, 1, schur='cg')
    assert g._pt_inc is None and g._cam_inc is None
    x = torch.randn((g.pixels.shape[0], 3, 3),
                    generator=torch.Generator().manual_seed(2))
    for name in ('_acc_cams', '_acc_points'):
        got = getattr(g, name)(dict(g._obs_data(), cam_win=None), x.to(cuda))
        again = getattr(g, name)(dict(g._obs_data(), cam_win=None),
                                 x.to(cuda))
        want = getattr(c, name)(dict(c._obs_data(), cam_win=None), x)
        assert torch.equal(got, again)
        assert torch.allclose(got.cpu(), want, rtol=1e-5, atol=1e-5)
