"""The port's CUDA kernels on an NVIDIA GPU (marked ``cuda``; each test
skips where torch has no CUDA device): the stencil CG solvers, the
nearest-neighbour and SE3 kernels against their plain versions, and the
paths through them.  This file imports no jax, so it
runs on a machine without the JAX package:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

(``--noconftest`` because tests/conftest.py configures jax.)
"""

import pytest
import torch

from pypose_tpu_torch.ops import knn, se3, stencil_cg as scg
from pypose_tpu_torch.testing import (nn1_tolerance_failures,
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


def _clouds(R, N, dev, seed=0, D=3):
    gen = torch.Generator().manual_seed(seed)
    return ((5.0 * torch.randn((R, D), generator=gen)).to(dev),
            (5.0 * torch.randn((N, D), generator=gen)).to(dev))


def _assert_knn_close(ref, nbr, d_k, i_k, d_p, i_p):
    """Indices equal on >= 99.99% of rows, d2 within
    1e-6 (|a|^2 + |b|^2) + 1e-6 everywhere."""
    d_k, i_k = d_k.reshape(len(ref), -1), i_k.reshape(len(ref), -1)
    d_p, i_p = d_p.reshape(len(ref), -1), i_p.reshape(len(ref), -1)
    bound = 1e-6 * ((ref * ref).sum(-1, keepdim=True)
                    + (nbr * nbr).sum(-1)[i_p]) + 1e-6
    assert float((i_k == i_p).all(-1).double().mean()) >= 0.9999
    assert bool(((d_k - d_p).abs() <= bound).all())
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
    _assert_knn_close(ref, nbr, d_k, i_k, *knn._nnk_torch(ref, nbr, k))


def test_knn_kernel_ties_and_refusals(cuda):
    """Duplicated neighbours: the lower index first; k above the kernel's
    largest, points of too many coordinates and float64 raise."""
    base = _clouds(1, 200, cuda)[1]
    nbr = torch.cat([base, base[:50]])
    d2, idx = knn.nnk(base[:50] + 1e-3, nbr, 2)
    assert torch.equal(idx[:, 0].cpu(), torch.arange(50))
    assert torch.equal(idx[:, 1].cpu(), 200 + torch.arange(50))
    with pytest.raises(ValueError, match='k=17'):
        knn.nnk(base, base, knn.MAX_K + 1)
    with pytest.raises(ValueError, match='coordinates'):
        knn.nn1(torch.zeros((4, 5), device=cuda),
                torch.zeros((6, 5), device=cuda))
    with pytest.raises(TypeError, match='float32'):
        knn.nn1(base.double(), base.double())


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
