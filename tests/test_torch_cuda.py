"""The port's CUDA kernels on an NVIDIA GPU (marked ``cuda``; each test
skips where torch has no CUDA device): the stencil CG solvers, the
nearest-neighbour and SE3 kernels against their plain versions, the paths
through them, and the general SparseLM routes, LSTSQ and EPnP (no kernel)
card against CPU.  This file imports no jax, so it
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
from pypose_tpu_torch.testing import cap_threads

cap_threads()

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
    """Duplicated neighbours: the lower index first; k above the number of
    neighbours, float16 clouds and clouds of two dtypes raise; points of
    more than 8 coordinates take the wide scans (one launch)."""
    base = _clouds(1, 200, cuda)[1]
    nbr = torch.cat([base, base[:50]])
    d2, idx = knn.nnk(base[:50] + 1e-3, nbr, 2)
    assert torch.equal(idx[:, 0].cpu(), torch.arange(50))
    assert torch.equal(idx[:, 1].cpu(), 200 + torch.arange(50))
    with pytest.raises(ValueError, match='k=201'):
        knn.nnk(base, base, 201)
    before = knn.NN1_LAUNCHES
    d2, idx = knn.nn1(torch.zeros((4, 9), device=cuda),
                      torch.zeros((6, 9), device=cuda))
    assert knn.NN1_LAUNCHES == before + 1
    assert not d2.any() and not idx.any()
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
    against the CPU's result; at D = 9 through the wide scans alike."""
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
    ref, nbr = (a.double() for a in _clouds(9000, 9000, cuda, seed=9, D=9))
    before = (knn.NN1_LAUNCHES, knn.NNK_LAUNCHES)
    res = knn_fn(ref, nbr, k=k)
    torch.cuda.synchronize()
    assert (knn.NN1_LAUNCHES, knn.NNK_LAUNCHES) == \
        (before[0] + (k == 1), before[1] + (k > 1))
    cpu = knn_fn(ref.cpu(), nbr.cpu(), k=k)
    got = nnk_tolerance_failures(ref, nbr, res.values ** 2, res.indices,
                                 cpu.indices.to(cuda), **F64_TOL)
    assert got['index_failures'] == got['repeat_failures'] == \
        got['d2_failures'] == 0, got


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('D', [9, 15, 16, 17, 33, 64, 128, 300])
def test_descriptor_kernels_match_plain(cuda, D, dtype):
    """The wide scans (D > 8; float32 on the tensor cores, its rows
    resident in shared memory up to 128 coordinates and streamed past):
    nn1 and nnk (k = 2, 8, 16), one launch each, under the near-tie rules
    (float64 at F64_TOL), on clouds whose sizes are not multiples of the
    tiles."""
    ref, nbr = (a.to(dtype) for a in _clouds(1001, 3003, cuda, seed=D, D=D))
    tol = F64_TOL if dtype == torch.float64 else {}
    for k in (1, 2, 8, 16):
        name = 'NN1_LAUNCHES' if k == 1 else 'NNK_LAUNCHES'
        before = getattr(knn, name)
        d_k, i_k = knn.nnk(ref, nbr, k)
        torch.cuda.synchronize()
        assert getattr(knn, name) == before + 1
        got = nnk_tolerance_failures(ref, nbr, d_k, i_k,
                                     knn._nnk_torch(ref, nbr, k)[1], **tol)
        assert got['index_failures'] == got['repeat_failures'] == \
            got['d2_failures'] == 0, got


def _descriptor_clouds(R, N, D, dev, seed):
    """FPFH-like clouds (uniform bins, each row summing to 100): the
    descriptors' own scale, where one TF32 pass breaks the near-tie
    rule."""
    gen = torch.Generator().manual_seed(seed)
    a, b = torch.rand((R, D), generator=gen), torch.rand((N, D), generator=gen)
    return ((100 * a / a.sum(1, keepdim=True)).to(dev),
            (100 * b / b.sum(1, keepdim=True)).to(dev))


@pytest.mark.parametrize('R,N', [(1, 20), (5, 63), (130, 50), (127, 64),
                                 (129, 65), (300, 1000)])
@pytest.mark.parametrize('D', [9, 33, 128])
def test_descriptor_kernels_ragged_shapes(cuda, R, N, D):
    """The float32 wide scans at row counts around a block's 128, neighbour
    counts around a tile's 64 and below it: nn1 and nnk (k = 2, 8, 16 up
    to N), one launch each, under the near-tie rules."""
    ref, nbr = _descriptor_clouds(R, N, D, cuda, seed=R + N + D)
    for k in (1, 2, 8, 16):
        if k > N:
            continue
        name = 'NN1_LAUNCHES' if k == 1 else 'NNK_LAUNCHES'
        before = getattr(knn, name)
        d_k, i_k = knn.nnk(ref, nbr, k)
        torch.cuda.synchronize()
        assert getattr(knn, name) == before + 1
        assert d_k.shape == i_k.shape == (R, k)
        assert (d_k[:, 1:] >= d_k[:, :-1]).all()
        _assert_nnk_within_tolerance(ref, nbr, d_k, i_k,
                                     knn._nnk_torch(ref, nbr, k)[1])


@pytest.mark.parametrize('D', [33, 128, 300])
def test_descriptor_kernels_rule_at_scale(cuda, D):
    """FPFH-like clouds of 2,000 x 20,000 in float32, whose large norms
    (|a|^2 ~ 10^2-10^4) make the tensor cores' truncating sums the
    largest share of the error: nn1 and nnk (k = 16) under the near-tie
    rules."""
    ref, nbr = _descriptor_clouds(2000, 20_000, D, cuda, seed=D)
    for k in (1, 16):
        d_k, i_k = knn.nnk(ref, nbr, k)
        _assert_nnk_within_tolerance(ref, nbr, d_k, i_k,
                                     knn._nnk_torch(ref, nbr, k)[1])


@pytest.mark.parametrize('D', [17, 33, 128])
def test_descriptor_kernels_exact_ties(cuda, D):
    """Duplicated neighbours (every point twice, and copies of some
    reference rows) in float32: nn1 takes the first of equal distances,
    as the plain version does; nnk's pairs of copies come lower index
    first; both under the near-tie rules."""
    ref, base = _descriptor_clouds(500, 700, D, cuda, seed=D)
    nbr = torch.cat([base, base, ref[:100]])
    d_k, i_k = knn.nn1(ref, nbr)
    _assert_nn1_within_tolerance(ref, nbr, d_k, i_k,
                                 knn._nn1_torch(ref, nbr)[1])
    assert not bool(((i_k >= 700) & (i_k < 1400)).any())
    assert torch.equal(i_k[:100].cpu(), 1400 + torch.arange(100))
    d_k, i_k = knn.nnk(ref, nbr, 4)
    _assert_nnk_within_tolerance(ref, nbr, d_k, i_k,
                                 knn._nnk_torch(ref, nbr, 4)[1])
    # a neighbour's copy ranks right after it (rows past 100 may also
    # find a reference row's copy, at 1400 and up, which has none)
    first = i_k[100:, 0]
    assert not bool(((first >= 700) & (first < 1400)).any())
    base_first = first < 700
    assert bool(base_first.any())
    assert torch.equal(i_k[100:, 1][base_first], first[base_first] + 700)


def test_descriptor_scratch_sizes(cuda):
    """The wide merge scans' scratch on the tensor cores: the split
    clouds (float64: its panels, at every k), zero for the register-tiled
    scans."""
    import ctypes
    lib = knn._kernel_lib()
    n = ctypes.c_longlong()
    assert lib.ppt_knn_scratch(20_000, 100_000, 128, 1, 0,
                               ctypes.byref(n)) == 0
    # 157 blocks of 128 rows and 1563 tiles of 64, each panel 64 x 128 x 2
    # words and 64 norms
    assert n.value == (2 * 157 + 1563) * (2 * 64 * 128 + 64)
    # float64: 2 panels of rows and 2 tiles, each 64 x 128 doubles and 64
    # norms, in float32 words
    assert lib.ppt_knn_scratch(100, 100, 128, 17, 1, ctypes.byref(n)) == 0
    assert n.value == (2 + 2) * (2 * 64 * 128 + 2 * 64)
    assert lib.ppt_knn_scratch(100, 100, 8, 1, 0, ctypes.byref(n)) == 0
    assert n.value == 0
    # float64 nn1 and k <= 16 read the same panels (DMMA)
    for k in (1, 16):
        assert lib.ppt_knn_scratch(100, 100, 128, k, 1, ctypes.byref(n)) == 0
        assert n.value == (2 + 2) * (2 * 64 * 128 + 2 * 64)
    plan = knn.nnk_plan(100, 100, 128, 16, torch.float64)
    assert (plan['family'], plan['scratch_bytes']) == ('tensor-core-f64',
                                                       4 * n.value)


# k > 16: the lists off the registers (csrc/knn.cu:nnk_warp_scan,
# wide_tc_scan<float, kBig> and wide_tc_scan<double, kBig>, DMMA), one
# launch each, under the near-tie rules (float64 at F64_TOL).
BIG_KS = (17, 31, 32, 33, 64, 100, 257, 1024)


def _assert_big(ref, nbr, k, **tol):
    before = knn.NNK_LAUNCHES
    d_k, i_k = knn.nnk(ref, nbr, k)
    torch.cuda.synchronize()
    assert knn.NNK_LAUNCHES == before + 1
    assert d_k.shape == i_k.shape == (ref.shape[0], k)
    assert d_k.dtype == ref.dtype and i_k.dtype == torch.int64
    assert (d_k[:, 1:] >= d_k[:, :-1]).all()
    got = nnk_tolerance_failures(ref, nbr, d_k, i_k,
                                 knn._nnk_torch(ref, nbr, k)[1], **tol)
    assert got['index_failures'] == got['repeat_failures'] == \
        got['d2_failures'] == 0, got
    return d_k, i_k


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('D', [1, 3, 4, 8, 9, 33, 128])
@pytest.mark.parametrize('k', BIG_KS)
def test_nnk_big_k_matches_plain(cuda, k, D, dtype):
    """Every k > 16 family (register-tiled up to D = 8, the float32
    tensor-core and float64 DMMA wide scans past it) on clouds of 333 x
    3003 (R not a multiple of a block's rows); k = 257 and 1024 merge
    many buffers into the lists."""
    ref, nbr = (a.to(dtype) for a in _clouds(333, 3003, cuda, seed=k + D,
                                             D=D))
    _assert_big(ref, nbr, k, **(F64_TOL if dtype == torch.float64 else {}))


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('D', [3, 33])
@pytest.mark.parametrize('R,N,k', [(1, 17, 17), (1, 300, 100), (50, 64, 64),
                                   (129, 40, 20), (129, 300, 300),
                                   (300, 4096, 4096)])
def test_nnk_big_k_ragged_and_whole_rows(cuda, R, N, k, D, dtype):
    """R = 1, R past a block's rows, N under one tile, and k = N (the
    whole row sorted)."""
    ref, nbr = (a.to(dtype) for a in _clouds(R, N, cuda, seed=R + N, D=D))
    _assert_big(ref, nbr, k, **(F64_TOL if dtype == torch.float64 else {}))


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('D', [3, 8, 33])
@pytest.mark.parametrize('k', [20, 64, 300])
def test_nnk_big_k_exact_ties(cuda, k, D, dtype):
    """Small-integer clouds, every neighbour four times over 40,000
    neighbours (several splits; a tensor-core row's four threads see
    interleaved columns): every score is exact in both versions, so the
    kernel's indices equal the plain version's, ties lower index first."""
    gen = torch.Generator().manual_seed(k + D)
    ref = torch.randint(0, 6, (500, D), generator=gen).to(dtype).to(cuda)
    base = torch.randint(0, 6, (10_000, D), generator=gen).to(dtype)
    nbr = base.repeat(4, 1).to(cuda)
    d_k, i_k = knn.nnk(ref, nbr, k)
    d_p, i_p = knn._nnk_torch(ref, nbr, k)
    assert torch.equal(i_k, i_p)
    assert torch.equal(d_k, d_p)


def test_knn_k30_launches_nnk_never_the_gram_path(cuda, monkeypatch):
    """knn(k=30) on CUDA, auto-tiled (past 64 Mi pairs) and with an
    explicit chunk, makes one nnk launch and never reaches _knn_gram."""
    from pypose_tpu_torch.function import geometry

    def refuse(*args):
        raise AssertionError('_knn_gram reached on CUDA')

    monkeypatch.setattr(geometry, '_knn_gram', refuse)
    ref, nbr = _clouds(9000, 9000, cuda, seed=30)
    for chunk in (None, 1000):
        before = (knn.NNK_LAUNCHES, knn.NN1_LAUNCHES)
        res = geometry.knn(ref, nbr, k=30, chunk=chunk)
        torch.cuda.synchronize()
        assert (knn.NNK_LAUNCHES, knn.NN1_LAUNCHES) == (before[0] + 1,
                                                        before[1])
        _assert_nnk_within_tolerance(ref, nbr, res.values ** 2,
                                     res.indices,
                                     knn._nnk_torch(ref, nbr, 30)[1])


def _old_nnk_lib(path):
    """An earlier csrc/knn.cu (its C interface with a scratch argument,
    as since the tensor-core scans; ``ppt_knn_scratch`` taking k or not,
    as its source says) built with the same flags."""
    import ctypes
    import hashlib
    from pypose_tpu_torch.ops import _build
    text = open(path, 'rb').read()
    takes_k = b'int ppt_knn_scratch(int R, int N, int D, int k,' in text
    selects = b'int ppt_nnk_select_scratch(' in text
    out = _build.BUILD / f'libknn_old_{hashlib.sha1(text).hexdigest()[:12]}.so'
    if not out.exists():
        _build.BUILD.mkdir(exist_ok=True)
        import subprocess
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, '-o',
                        str(out), str(path)], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn, args in (('ppt_knn_scratch',
                      [I] * (5 if takes_k else 4)
                      + [ctypes.POINTER(ctypes.c_longlong)]),
                     ('ppt_nnk_splits', [I] * 5),
                     ('ppt_nnk', [P, P] + [I] * 6 + [P] * 6)):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = I
    if selects:
        lib.ppt_nnk_select_scratch.argtypes = [I] * 5 + [
            ctypes.POINTER(ctypes.c_longlong)]
        lib.ppt_nnk_select_scratch.restype = I
    lib.takes_k, lib.selects = takes_k, selects
    return lib


def _nnk_with(lib, ref, nbr, k):
    """ops/knn.py:_launch_nnk through ``lib`` (the select path's scratch
    where ``lib`` has one and takes it at k)."""
    import ctypes
    (R, D), N = ref.shape, nbr.shape[0]
    f64 = int(ref.dtype == torch.float64)
    splits = lib.ppt_nnk_splits(R, N, D, k, f64)
    part_s = torch.empty((splits, k, R), dtype=ref.dtype, device=ref.device)
    part_i = torch.empty((splits, k, R), dtype=torch.int32,
                         device=ref.device)
    floats = ctypes.c_longlong()
    assert lib.ppt_knn_scratch(R, N, D, *((k,) if lib.takes_k else ()), f64,
                               ctypes.byref(floats)) == 0
    sel = ctypes.c_longlong(-1)
    if lib.selects:
        assert lib.ppt_nnk_select_scratch(R, N, D, k, f64,
                                          ctypes.byref(sel)) == 0
    scratch = torch.empty((max(1, 4 * floats.value, sel.value),),
                          dtype=torch.uint8, device=ref.device)
    d2 = torch.empty((R, k), dtype=ref.dtype, device=ref.device)
    idx = torch.empty((R, k), dtype=torch.int64, device=ref.device)
    assert lib.ppt_nnk(ref.data_ptr(), nbr.data_ptr(), R, N, D, k, f64,
                       splits, scratch.data_ptr(), part_s.data_ptr(),
                       part_i.data_ptr(), d2.data_ptr(), idx.data_ptr(),
                       torch.cuda.current_stream().cuda_stream) == 0
    return d2, idx


@pytest.mark.parametrize('D,dtype', [(3, torch.float32),
                                     (33, torch.float32),
                                     (3, torch.float64)])
def test_small_k_bit_equal_to_an_earlier_build(cuda, D, dtype):
    """k = 2, 8, 16 give the same bits as an earlier csrc/knn.cu (the
    instantiations of the register lists), built beside this one from
    the file named by $PPT_KNN_OLD_CU (e.g. ``git show
    66cd375:pypose_tpu_torch/csrc/knn.cu``).  Float64 past 8 coordinates
    now sums on DMMA, in another order than the earlier SIMT scans:
    test_wide_f64_small_k_bit_equal_to_the_dmma_merge_scan holds it."""
    import os
    path = os.environ.get('PPT_KNN_OLD_CU')
    if not path:
        pytest.skip('PPT_KNN_OLD_CU names no earlier csrc/knn.cu')
    old = _old_nnk_lib(path)
    ref, nbr = (a.to(dtype) for a in _clouds(3000, 20_000, cuda, seed=D,
                                             D=D))
    for k in (2, 8, 16):
        d_o, i_o = _nnk_with(old, ref, nbr, k)
        d_n, i_n = knn.nnk(ref, nbr, k)
        assert torch.equal(i_o, i_n) and torch.equal(d_o, d_n), (D, k)


@pytest.mark.parametrize('D', [9, 33, 64, 128, 300])
def test_wide_f64_small_k_bit_equal_to_the_dmma_merge_scan(cuda, D):
    """Float64 nn1 and nnk up to k = 16 past 8 coordinates run on DMMA
    (wide_tc_scan<double, K>): under the near-tie rule at F64_TOL against
    the plain version, and bit for bit the DMMA merge scan's first
    columns, which forms the same s in the same order: nnk(16) is
    nnk(32)[:, :16] and nn1 is nnk(2)[:, :1]."""
    ref, nbr = (_sift_clouds(1001, 3003, cuda, seed=D) if D == 128 else
                _descriptor_clouds(1001, 3003, D, cuda, seed=D))
    ref, nbr = ref.double(), nbr.double()
    for k in (2, 4, 8, 16, 32):
        assert knn.nnk_plan(1001, 3003, D, k, torch.float64)['family'] == \
            'tensor-core-f64'
    outs = {k: _assert_big(ref, nbr, k, **F64_TOL) for k in (2, 4, 16, 32)}
    assert knn.nnk_plan(1001, 3003, D, 32, torch.float64)['route'] == 'scan'
    d1, i1 = knn.nn1(ref, nbr)
    got = nnk_tolerance_failures(ref, nbr, d1[:, None], i1[:, None],
                                 knn._nn1_torch(ref, nbr)[1][:, None],
                                 **F64_TOL)
    assert got['index_failures'] == got['d2_failures'] == 0, got
    assert torch.equal(outs[16][0], outs[32][0][:, :16])
    assert torch.equal(outs[16][1], outs[32][1][:, :16])
    assert torch.equal(d1, outs[2][0][:, 0])
    assert torch.equal(i1, outs[2][1][:, 0])
    assert torch.equal(outs[4][1], outs[16][1][:, :4])


# The register-tiled merge scan past k = 16 (csrc/knn.cu:nnk_warp_scan):
# its k values, each Tile layout (D = 1-3, 4, 5-7 and 8), both types,
# with one split and with several.
WARP_KS = (17, 30, 50, 100)
WARP_SHAPES = ((333, 20_011), (20_011, 3_003))


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('D', [1, 3, 4, 6, 8])
@pytest.mark.parametrize('R,N', WARP_SHAPES)
def test_warp_merge_scan_bit_equal_to_an_earlier_build(cuda, R, N, D, dtype):
    """The warp merge scan at k = 17, 30, 50, 100 and select_k - 1, on
    ragged R and N (333 rows against 20,011 neighbours: several splits;
    20,011 rows against 3,003: one split, no merge pass), gives the same
    d^2 and index bits as an earlier csrc/knn.cu's merge scan past k = 16
    (the file named by $PPT_KNN_OLD_CU, e.g. ``git show
    89bb3cd:pypose_tpu_torch/csrc/knn.cu``): both rank the same s, by the
    same FMA chain, in the same (s, index) order; and holds the near-tie
    rule against the plain version (float64 at F64_TOL)."""
    import os
    ref, nbr = (a.to(dtype) for a in _clouds(R, N, cuda, seed=R + D, D=D))
    sel = knn.select_k(dtype, R, D)
    splits = set()
    for k in sorted({k for k in WARP_KS if k < sel} | {sel - 1}):
        plan = knn.nnk_plan(R, N, D, k, dtype)
        assert (plan['route'], plan['family']) == ('scan', 'register-tiled')
        assert (plan['part_bytes'] == 0) == (plan['splits'] == 1)
        splits.add(plan['splits'] > 1)
        d_n, i_n = _assert_big(ref, nbr, k, **(F64_TOL if dtype ==
                                               torch.float64 else {}))
        path = os.environ.get('PPT_KNN_OLD_CU')
        if path:
            d_o, i_o = _nnk_with(_old_nnk_lib(path), ref, nbr, k)
            assert torch.equal(i_o, i_n) and torch.equal(d_o, d_n), k
    assert splits == {R < N}


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('D', [1, 3, 8])
def test_warp_merge_scan_exact_ties(cuda, D, dtype):
    """Small-integer clouds, every neighbour eight times: runs of equal
    scores far longer than a batch, across batches, merges and splits;
    the indices and d^2 equal the plain version's (lower index first) at
    k = 17, 64 and 100 (those below select_k) and select_k - 1, and an
    earlier build's where $PPT_KNN_OLD_CU names one."""
    import os
    gen = torch.Generator().manual_seed(D)
    ref = torch.randint(0, 4, (701, D), generator=gen).to(dtype).to(cuda)
    base = torch.randint(0, 4, (2_501, D), generator=gen).to(dtype)
    nbr = base.repeat(8, 1).to(cuda)
    path = os.environ.get('PPT_KNN_OLD_CU')
    sel = knn.select_k(dtype, 701, D)
    for k in sorted({k for k in (17, 64, 100) if k < sel} | {sel - 1}):
        assert knn.nnk_plan(701, 20_008, D, k, dtype)['route'] == 'scan'
        d_k, i_k = knn.nnk(ref, nbr, k)
        d_p, i_p = knn._nnk_torch(ref, nbr, k)
        assert torch.equal(i_k, i_p) and torch.equal(d_k, d_p), k
        if path:
            d_o, i_o = _nnk_with(_old_nnk_lib(path), ref, nbr, k)
            assert torch.equal(i_o, i_k) and torch.equal(d_o, d_k), k


# The select-then-sort paths (csrc/knn.cu:launch_nnk_select,
# launch_nnk_wide_select): D <= 8, and float32 past 8, at
# k >= knn.select_k(dtype, R, D) and at k = N.
def _assert_select(ref, nbr, k, **tol):
    (R, D), N = ref.shape, nbr.shape[0]
    assert knn.nnk_plan(R, N, D, k, ref.dtype)['route'] == 'select'
    return _assert_big(ref, nbr, k, **tol)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('D', [3, 6])
def test_select_path_bit_equal_to_an_earlier_build(cuda, D, dtype):
    """k = select_k - 1 (the scan), select_k (each dtype's), 1024 and N
    give the same
    d^2 and index bits as an earlier csrc/knn.cu (the merge scan past
    k = 16: e.g. ``git show 42cbb8c:pypose_tpu_torch/csrc/knn.cu``), built
    beside this one from the file named by $PPT_KNN_OLD_CU: both rank the
    same s, by the same FMA chain, in the same (s, index) order."""
    import os
    path = os.environ.get('PPT_KNN_OLD_CU')
    if not path:
        pytest.skip('PPT_KNN_OLD_CU names no earlier csrc/knn.cu')
    old = _old_nnk_lib(path)
    ref, nbr = (a.to(dtype) for a in _clouds(3001, 20_011, cuda, seed=D,
                                             D=D))
    sel = knn.select_k(dtype, 3001, D)
    for k in (sel - 1, sel, 1024):
        route = knn.nnk_plan(3001, 20_011, D, k, dtype)['route']
        assert route == ('scan' if k < sel else 'select'), k
        d_o, i_o = _nnk_with(old, ref, nbr, k)
        d_n, i_n = knn.nnk(ref, nbr, k)
        assert torch.equal(i_o, i_n) and torch.equal(d_o, d_n), (D, k)
    ref, nbr = ref[:500].contiguous(), nbr[:3003].contiguous()
    d_o, i_o = _nnk_with(old, ref, nbr, 3003)
    d_n, i_n = knn.nnk(ref, nbr, 3003)
    assert torch.equal(i_o, i_n) and torch.equal(d_o, d_n), (D, 'N')


def test_select_route_starts_at_select_k(cuda):
    """The register-tiled family takes the select path from select_k on
    (csrc/knn.cu's crossovers, each past 16: since the warp merge scan
    float32's the same at 10,000 rows as at 100,000, float64's higher at
    10,000) and at k = N (any k), the scans below; the float64 wide
    family from its own crossover on and at k = N (any k), the DMMA scans
    below, up to k = 16 too."""
    for dtype in (torch.float32, torch.float64):
        for R in (1000, 100_000):
            sel = knn.select_k(dtype, R)
            assert 16 < sel <= 1024, (dtype, R, sel)

            def plan(N, D, k):
                return knn.nnk_plan(R, N, D, k, dtype)['route']
            assert plan(5000, 3, sel - 1) == 'scan'
            assert plan(5000, 3, sel) == 'select'
            assert plan(5000, 8, 5000) == 'select'
            assert plan(20, 1, 20) == 'select'
            assert plan(5000, 3, 16) == 'scan'
    assert knn.select_k(torch.float32, 1000) == \
        knn.select_k(torch.float32, 100_000)
    assert knn.select_k(torch.float64, 1000) > \
        knn.select_k(torch.float64, 100_000)
    sel = knn.select_k(torch.float64, 1000, 9)
    assert 16 < sel <= 1024
    for k, route in ((2, 'scan'), (16, 'scan'), (17, 'scan'),
                     (sel - 1, 'scan'), (sel, 'select'), (1024, 'select'),
                     (5000, 'select')):
        plan = knn.nnk_plan(1000, 5000, 9, k, torch.float64)
        assert (plan['route'], plan['family']) == (route,
                                                   'tensor-core-f64'), k
    plan = knn.nnk_plan(1000, 16, 9, 16, torch.float64)
    assert (plan['route'], plan['family']) == ('select', 'tensor-core-f64')


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('R,N,k,D', [
    (1, 700, 512, 3), (1, 100_000, 1024, 3), (7, 100_003, 600, 2),
    (129, 333, 333, 1), (333, 3003, 513, 4), (333, 3003, 1024, 8),
    (1000, 1000, 999, 5), (200, 9000, 7000, 3), (3, 20_000, 20_000, 3),
    (5, 12_000, 9000, 6)])
def test_select_path_ragged_shapes(cuda, R, N, k, D, dtype):
    """R = 1, R small against N = 100k (many splits), R and N not a
    multiple of a block or a tile, k = N in one block, and past one
    block's 8192 pairs (the sort's steps in global memory: k = N = 20,000
    and k = 9000, 7000)."""
    ref, nbr = (a.to(dtype) for a in _clouds(R, N, cuda, seed=R + k, D=D))
    _assert_select(ref, nbr, k, **(F64_TOL if dtype == torch.float64
                                   else {}))


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('k', [520, 600, 1999, 40_000])
def test_select_path_exact_ties_at_the_threshold(cuda, k, dtype):
    """Small-integer clouds, every neighbour four times over 40,000: exact
    scores, runs of equal ones hundreds long, so the k-th pair falls
    inside a run and the cut goes by index (the index digits); the
    indices and d^2 equal the plain version's and the CPU emulation's
    (ops/knn.py:_nnk_select), the lower index first."""
    gen = torch.Generator().manual_seed(k)
    ref = torch.randint(0, 5, (300, 3), generator=gen).to(dtype)
    base = torch.randint(0, 5, (10_000, 3), generator=gen).to(dtype)
    nbr = base.repeat(4, 1)
    d_e, i_e = knn._nnk_select(ref, nbr, k)
    ref, nbr = ref.to(cuda), nbr.to(cuda)
    d_k, i_k = _assert_select(ref, nbr, k)
    d_p, i_p = knn._nnk_torch(ref, nbr, k)
    assert torch.equal(i_k, i_p) and torch.equal(d_k, d_p)
    assert torch.equal(i_k.cpu(), i_e) and torch.equal(d_k.cpu(), d_e)


def test_select_path_k4096_at_100k_rows(cuda):
    """k = 4096 on ICP-scale clouds (100,000 x 100,000): the outputs take
    4.9 GB, and the select path's scratch ~0.52 GB beside them (the merge
    scan's one split of lists took 3.3 GB); the call allocates nothing
    else (up to the caching allocator's rounding: 2 MB a block, three
    blocks).  Rows sorted, every 997th row held to the plain version."""
    ref, nbr = _clouds(100_000, 100_000, cuda, seed=4096)
    k, R = 4096, 100_000
    plan = knn.nnk_plan(R, R, 3, k, torch.float32)
    out = R * k * (4 + 8)
    per_row = sum((b + 255) // 256 * 256 for b in (24 * R, 1024 * R,
                                                   8 * R, 512 * 8 * R))
    assert plan['route'] == 'select' and plan['scratch_bytes'] == per_row
    assert plan['scratch_bytes'] < 0.11 * out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    d_k, i_k = knn.nnk(ref, nbr, k)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before <= \
        out + plan['scratch_bytes'] + 3 * (2 << 20)
    assert (d_k[:, 1:] >= d_k[:, :-1]).all()
    rows = torch.arange(0, R, 997, device=cuda)
    got = nnk_tolerance_failures(ref[rows], nbr, d_k[rows], i_k[rows],
                                 knn._nnk_torch(ref[rows], nbr, k)[1])
    assert got['index_failures'] == got['repeat_failures'] == \
        got['d2_failures'] == 0, got


def test_knn_k_above_n_raises_before_any_launch(cuda):
    """knn with k > N raises ValueError on the chunked path (the kernels'
    route) and the dense one, as the JAX package does, and launches
    nothing; k = N still returns N columns."""
    from pypose_tpu_torch.function import geometry
    ref, nbr = _clouds(4, 5, cuda)
    before = (knn.NN1_LAUNCHES, knn.NNK_LAUNCHES)
    for chunk in (2, None):
        with pytest.raises(ValueError, match='k=7'):
            geometry.knn(ref, nbr, k=7, chunk=chunk)
    assert (knn.NN1_LAUNCHES, knn.NNK_LAUNCHES) == before
    res = geometry.knn(ref, nbr, k=5, chunk=2)
    assert res.indices.shape == (4, 5)
    assert knn.NNK_LAUNCHES == before[1] + 1


def test_knn_negative_k_raises_before_any_launch(cuda):
    """knn with k < 0 raises ValueError on the chunked path (the kernels'
    route) and the dense one, as the JAX package does, and so does
    knn_filter at a top-(k + 1) below 0; no kernel launches."""
    from pypose_tpu_torch.function import geometry
    ref, nbr = _clouds(4, 5, cuda)
    before = (knn.NN1_LAUNCHES, knn.NNK_LAUNCHES)
    for k in (-1, -3):
        for chunk in (2, None):
            with pytest.raises(ValueError, match=f'k={k} must be'):
                geometry.knn(ref, nbr, k=k, chunk=chunk)
    with pytest.raises(ValueError, match='k=-1 must be'):
        geometry.knn_filter(nbr, -2, radius=1.0)
    assert (knn.NN1_LAUNCHES, knn.NNK_LAUNCHES) == before


@pytest.mark.parametrize('D', [33, 128])
def test_wide_knn_k_above_n_raises_before_any_launch(cuda, D):
    """knn with k > N raises ValueError on descriptor clouds too, before
    the select path's plan runs, and launches nothing; k = N (the wide
    select path) returns N columns under the near-tie rule."""
    from pypose_tpu_torch.function import geometry
    ref, nbr = _descriptor_clouds(40, 50, D, cuda, seed=D)
    before = (knn.NN1_LAUNCHES, knn.NNK_LAUNCHES)
    for chunk in (7, None):
        with pytest.raises(ValueError, match='k=51'):
            geometry.knn(ref, nbr, k=51, chunk=chunk)
    with pytest.raises(ValueError, match='k=51'):
        knn.nnk(ref, nbr, 51)
    assert (knn.NN1_LAUNCHES, knn.NNK_LAUNCHES) == before
    assert knn.nnk_plan(40, 50, D, 50, torch.float32)['route'] == 'select'
    _assert_big(ref, nbr, 50)


def test_wide_nnk_plan_reports_select(cuda):
    """nnk_plan for float32 past 8 coordinates: the tensor-core family,
    'select' from select_k(float32, R, D) on and at k = N (its scratch the
    split clouds and the select state, no partial lists), 'scan' below;
    the crossover is past 16 and no lower at D = 128 than at D = 33."""
    import ctypes
    lib = knn._kernel_lib()
    for D in (9, 33, 128, 300):
        R, N = 2000, 20_000
        sel = knn.select_k(torch.float32, R, D)
        assert 16 < sel <= 1024, (D, sel)
        below = knn.nnk_plan(R, N, D, sel - 1, torch.float32)
        assert (below['route'], below['family']) == ('scan', 'tensor-core')
        assert below['select_k'] == sel and below['part_bytes'] > 0
        for k in (sel, 1024, N):
            plan = knn.nnk_plan(R, N, D, k, torch.float32)
            assert (plan['route'], plan['family']) == ('select',
                                                       'tensor-core'), k
            assert plan['splits'] == 1 and plan['part_bytes'] == 0
            floats = ctypes.c_longlong()
            assert lib.ppt_knn_scratch(R, N, D, k, 0,
                                       ctypes.byref(floats)) == 0
            assert plan['scratch_bytes'] > 4 * floats.value + 1024 * R
    assert knn.select_k(torch.float32, 2000, 33) <= \
        knn.select_k(torch.float32, 2000, 128)


def test_wide_nnk_plan_reports_select_f64(cuda):
    """nnk_plan for float64 past 8 coordinates: the DMMA family past
    k = 16, 'select' from select_k(float64, R, D) on and at k = N (its
    scratch the float64 panels and the select state, no partial lists),
    'scan' below (the merge scan: partial lists and the panels), and up to
    k = 16 the DMMA scans on the same panels."""
    import ctypes
    lib = knn._kernel_lib()
    for D in (9, 33, 128, 300):
        R, N = 2000, 20_000
        sel = knn.select_k(torch.float64, R, D)
        assert 16 < sel <= 1024, (D, sel)
        floats = ctypes.c_longlong()
        assert lib.ppt_knn_scratch(R, N, D, sel - 1, 1,
                                   ctypes.byref(floats)) == 0
        assert floats.value > 0
        below = knn.nnk_plan(R, N, D, sel - 1, torch.float64)
        assert (below['route'], below['family']) == ('scan',
                                                     'tensor-core-f64')
        assert below['select_k'] == sel and below['part_bytes'] > 0
        assert below['scratch_bytes'] == 4 * floats.value
        for k in (sel, 1024, N):
            plan = knn.nnk_plan(R, N, D, k, torch.float64)
            assert (plan['route'], plan['family']) == ('select',
                                                       'tensor-core-f64'), k
            assert plan['splits'] == 1 and plan['part_bytes'] == 0
            assert plan['scratch_bytes'] > 4 * floats.value + 1024 * R
        small = knn.nnk_plan(R, N, D, 16, torch.float64)
        assert (small['route'], small['family'], small['scratch_bytes']) \
            == ('scan', 'tensor-core-f64', 4 * floats.value)


def _sift_clouds(R, N, dev, seed):
    """SIFT-like clouds (128 values, unit length, clipped at 0.2 and
    normalised again), as chip_smoke.descriptors draws them."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for n in (R, N):
        v = torch.rand((n, 128), generator=gen, dtype=torch.float64)
        v = (v / v.norm(dim=-1, keepdim=True)).clamp(max=0.2)
        out.append((v / v.norm(dim=-1, keepdim=True)).float().to(dev))
    return out


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('D', [9, 33, 128, 300])
def test_wide_select_bit_equal_to_the_merge_scan(cuda, D, dtype):
    """The wide select path (csrc/knn.cu:launch_nnk_wide_select) at its
    crossover, at 1024 and at k = N gives the same d^2 and index bits as
    the tensor-core merge scan forced at the same k (knn._nnk_wide_merge):
    both rank the same s (float32: three-pass TF32; float64: DMMA) in the
    same (s, index) order; and holds the near-tie rule (float64 at
    F64_TOL)."""
    ref, nbr = (_sift_clouds(1500, 20_011, cuda, seed=D) if D == 128
                else _descriptor_clouds(1500, 20_011, D, cuda, seed=D))
    ref, nbr = ref.to(dtype), nbr.to(dtype)
    tol = F64_TOL if dtype == torch.float64 else {}
    sel = knn.select_k(dtype, 1500, D)
    for k in (sel, 1024):
        assert knn.nnk_plan(1500, 20_011, D, k, dtype)['route'] == 'select'
        d_m, i_m = knn._nnk_wide_merge(ref, nbr, k)
        d_s, i_s = _assert_big(ref, nbr, k, **tol)
        assert torch.equal(i_m, i_s) and torch.equal(d_m, d_s), (D, k)
    ref, nbr = ref[:300].contiguous(), nbr[:3003].contiguous()
    d_m, i_m = knn._nnk_wide_merge(ref, nbr, 3003)
    d_s, i_s = _assert_big(ref, nbr, 3003, **tol)
    assert torch.equal(i_m, i_s) and torch.equal(d_m, d_s), (D, 'N')


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('far', [False, True])
def test_wide_select_sampled_digit(cuda, far, dtype):
    """The wide select path guesses each row's first digit (float32 and
    float64 alike) from every 8th tile of 64 neighbours and checks the guess
    in the next pass: on clouds whose sampled tiles are like the rest the
    guess holds, and where every sampled tile lies far off (50 added to
    each of its coordinates) the guess fails and the row starts over;
    both ways the bits equal the merge scan's, under the near-tie rule
    (float64 at F64_TOL)."""
    ref, nbr = _descriptor_clouds(700, 64 * 8 * 40, 33, cuda, seed=7)
    ref, nbr = ref.to(dtype), nbr.to(dtype)
    if far:
        tile = torch.arange(nbr.shape[0], device=cuda) // 64
        nbr = torch.where((tile % 8 == 0)[:, None], nbr + 50.0, nbr)
    d_m, i_m = knn._nnk_wide_merge(ref, nbr, 1024)
    d_s, i_s = _assert_big(ref, nbr, 1024,
                           **(F64_TOL if dtype == torch.float64 else {}))
    assert torch.equal(i_m, i_s) and torch.equal(d_m, d_s)


@pytest.mark.parametrize('k', [17, 32, 100])
def test_sift_width_big_k_on_the_tensor_cores(cuda, k):
    """SIFT-like clouds (D = 128) at 16 < k below the crossover take the
    tensor-core merge scan (its buffers past a ring of 32-coordinate
    stages; no SIMT float32 scan is left), one launch, under the near-tie
    rule against the plain version; exact ties (every neighbour twice)
    come lower index first."""
    ref, nbr = _sift_clouds(2000, 30_000, cuda, seed=k)
    plan = knn.nnk_plan(2000, 30_000, 128, k, torch.float32)
    assert (plan['route'], plan['family']) == ('scan', 'tensor-core')
    _assert_big(ref, nbr, k)
    twice = torch.cat([nbr[:5000], nbr[:5000]])
    d_k, i_k = knn.nnk(ref, twice, k)
    _assert_nnk_within_tolerance(ref, twice, d_k, i_k,
                                 knn._nnk_torch(ref, twice, k)[1])
    # equal d^2 in ascending index, and every copy after its original,
    # at the same d^2
    same = d_k[:, 1:] == d_k[:, :-1]
    assert bool((i_k[:, 1:][same] > i_k[:, :-1][same]).all())
    copy = i_k >= 5000
    orig = i_k[:, None, :] == (i_k - 5000)[:, :, None]
    assert bool(copy.any()) and bool(orig.any(-1)[copy].all())
    before = torch.arange(k, device=cuda)[None, :] < \
        torch.arange(k, device=cuda)[:, None]
    assert bool((orig & before[None]).any(-1)[copy].all())


def test_select_path_d6_f64_k256_at_10k_rows(cuda):
    """[knn-d6]'s float64 clouds (10,000 x 10,000, D = 6) at k = 256 and at
    select_k: at 10,000 rows the warp merge scan wins up to k = 384 and
    the select path from 448 (PERF.md's crossover table: 1.65 against
    2.28 ms at 256, 3.54 against 3.09 at 448), so k = 256 takes the scan
    and select_k (448) the select path; both under the near-tie rule
    (F64_TOL), and bit for bit an earlier csrc/knn.cu where
    $PPT_KNN_OLD_CU names one (e.g. ``git show
    89bb3cd:pypose_tpu_torch/csrc/knn.cu``)."""
    import os
    gen = torch.Generator().manual_seed(0)
    ref, nbr = (torch.randn((10_000, 6), generator=gen).double().to(cuda)
                for _ in range(2))
    sel = knn.select_k(torch.float64, 10_000, 6)
    assert 256 < sel <= 512
    assert knn.nnk_plan(10_000, 10_000, 6, 256, torch.float64)['route'] \
        == 'scan'
    outs = {256: _assert_big(ref, nbr, 256, **F64_TOL),
            sel: _assert_select(ref, nbr, sel, **F64_TOL)}
    path = os.environ.get('PPT_KNN_OLD_CU')
    if path:
        for k, (d_k, i_k) in outs.items():
            d_o, i_o = _nnk_with(_old_nnk_lib(path), ref, nbr, k)
            assert torch.equal(i_o, i_k) and torch.equal(d_o, d_k), k


def test_sharded_pgo_one_rank_matches_sparse_lm(cuda):
    """ShardedPGO at one rank (make_mesh() with nothing set up: an NCCL
    group of one) against SparseLM(matvec='generic', scatter=False) on a
    sphere graph, five steps: chi2 within 1e-5 relative, no kernel."""
    import torch.distributed as dist
    from pypose_tpu_torch.datasets import synthetic_sphere
    from pypose_tpu_torch.optim.sparse import SparseLM, pgo_factor
    from pypose_tpu_torch.optim.strategy import TrustRegion
    from pypose_tpu_torch.parallel import ShardedPGO, make_mesh
    ds = synthetic_sphere(500, device=cuda)
    created = not dist.is_initialized()
    try:
        mesh = make_mesh()
        assert mesh.device_type == 'cuda'
        before = (scg.LAUNCHES, scg.FUSED_LAUNCHES)
        s = ShardedPGO(ds['nodes'], ds['edges'], ds['poses'], mesh=mesh,
                       cg_iter=100, cg_tol=1e-6)
        got = [s.step() for _ in range(5)]
        assert (scg.LAUNCHES, scg.FUSED_LAUNCHES) == before
    finally:
        if created:
            dist.destroy_process_group()
    fixed = torch.zeros(500, dtype=torch.bool, device=cuda)
    fixed[0] = True
    ref = SparseLM({'poses': ds['nodes']},
                   [pgo_factor(ds['edges'], ds['poses'])],
                   strategy=TrustRegion(radius=1e4), fixed={'poses': fixed},
                   cg_iter=100, cg_tol=1e-6, matvec='generic', scatter=False)
    want = [ref.step() for _ in range(5)]
    assert ref.route == 'einsum'
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-5 * abs(b)


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
    within 1e-4 of the CPU's; the same graph at t = 5 takes 'stencil'
    too, through the kernel's runtime-t instantiation."""
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
    card, cpu = _steps_card_and_cpu(make5, 2, route='stencil')
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


@pytest.mark.parametrize('t,nodes_in_smem', [
    (1, 8283), (2, 3624), (3, 2147), (4, 1449), (5, 1054), (6, 805),
    (7, 637), (8, 517), (9, 429), (16, 164), (17, 148)])
def test_fused_plan_takes_block_size(cuda, t, nodes_in_smem):
    """The fused kernel's shared-memory mode holds 6t + tt floats a node
    within 232,448 - 512 bytes a CTA: 2,147 nodes a CTA at t = 3, 1,449 at
    t = 4, 805 at t = 6 and 637 at t = 7 (517 at t = 8, 429 at t = 9);
    the 100k shape (758 nodes a CTA on 132 SMs) is within it at t <= 6
    and in global-memory mode from t = 7; on both sides of the switch at
    each t; t < 1 is refused."""
    assert (232_448 - 512) // (4 * (6 * t + t * t)) == nodes_in_smem
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    edge = [sms * nodes_in_smem, sms * nodes_in_smem + sms]
    for N in (53, 100_000, 200_000, *edge):
        plan = scg.fused_plan(N, t, cuda)
        assert plan['nodes_per_cta'] == -(-N // min(sms, max(1, N // 8)))
        assert plan['smem'] == (plan['nodes_per_cta'] <= nodes_in_smem)
    assert [scg.fused_plan(N, t, cuda)['smem'] for N in edge] == \
        [True, False]
    for bad in (0, -1):
        with pytest.raises(RuntimeError, match='invalid argument'):
            scg.fused_plan(100, bad, cuda)


def test_other_block_sizes_raise_on_card(cuda):
    """t = 0 and 17 offsets: every wrapper raises on CUDA tensors before
    any launch (no fall to the plain version); the C entry points refuse
    them too, the runtime-t ones included."""
    import ctypes
    gen = torch.Generator(device=cuda).manual_seed(0)
    offsets, ops = random_stencil_system(40, 9, 15, False, gen, cuda, t=5)
    empty = [torch.empty((0, 40), device=cuda) for _ in range(4)]
    many = tuple(range(1, 18))
    wide = [ops[0], ops[1], ops[2],
            torch.zeros((17 * 25, 40), device=cuda)]
    counters = ('LAUNCHES', 'FUSED_LAUNCHES', 'TILED_MV_LAUNCHES',
                'TILED_PC_LAUNCHES')
    before = [getattr(scg, c) for c in counters]
    for solver in (scg.stencil_cg_transposed, scg.stencil_cg_tiled,
                   scg.stencil_cg_fused):
        for any_t in (False, True):
            with pytest.raises(ValueError, match='t >= 1'):
                solver(*empty, offsets, 0, 5, 1e-6, any_t=any_t)
            with pytest.raises(ValueError, match='17 offsets'):
                solver(*wide, many, 5, 5, 1e-6, any_t=any_t)
    for any_t in (False, True):
        with pytest.raises(RuntimeError, match='invalid argument'):
            scg._tiled_pc_launch(ops[2], ops[0], 0, any_t)
        with pytest.raises(RuntimeError, match='invalid argument'):
            scg._tiled_mv_launch(ops[1], wide[3], ops[0], many, 5, any_t)
    lib = scg._kernel_lib('stencil_cg')
    x = torch.empty_like(ops[0])
    scratch = torch.empty((2, 5, 40), device=cuda)
    it = torch.empty((1,), dtype=torch.int32, device=cuda)
    for entry in (lib.ppt_stencil_pcg, lib.ppt_stencil_pcg_any_t):
        for t, offs in ((0, offsets), (5, many)):
            rc = entry(t, ops[0].data_ptr(), ops[1].data_ptr(),
                       ops[2].data_ptr(), wide[3].data_ptr(),
                       scg._c_offsets(offs, 40), len(offs), 40, 5, 1e-6,
                       x.data_ptr(), scratch.data_ptr(), it.data_ptr(),
                       ctypes.c_void_p(0))
            assert lib.ppt_cuda_error_string(rc).decode() == \
                'invalid argument'
    torch.cuda.synchronize()
    assert [getattr(scg, c) for c in counters] == before


# block sizes 1-17: the templates' 3, 4, 6, 7 and the runtime-t
# instantiation at every other
ALL_T = tuple(range(1, 18))


def _any_t_solver(solver, b_T, ops, offsets, t, maxiter, tol, any_t=False):
    """(kernel call, plain version, stored operands) of ``solver`` ('whole',
    'tiled', 'fused' or 'fused_bf16') on one system."""
    if solver == 'whole':
        return (lambda: scg.stencil_cg_transposed(
            b_T, *ops, offsets, t, maxiter, tol, any_t=any_t),
            scg._cg_body_torch, ops)
    if solver == 'tiled':
        return (lambda: scg.stencil_cg_tiled(
            b_T, *ops, offsets, t, maxiter, tol, any_t=any_t),
            scg._tiled_cg_torch, ops)
    dtype = torch.bfloat16 if solver == 'fused_bf16' else None
    stored = scg.round_operands(*ops, dtype)
    return (lambda: scg.stencil_cg_fused(
        b_T, *stored, offsets, t, maxiter, tol, operand_dtype=dtype,
        any_t=any_t), scg._fused_cg_torch, stored)


_ANY_T_COUNTER = {'whole': 'LAUNCHES', 'tiled': 'TILED_MV_LAUNCHES',
                  'fused': 'FUSED_LAUNCHES', 'fused_bf16': 'FUSED_LAUNCHES'}


@pytest.mark.parametrize('t', ALL_T)
@pytest.mark.parametrize('solver', ['whole', 'tiled', 'fused', 'fused_bf16'])
def test_any_t_solvers_match_plain(cuda, solver, t):
    """Every block size from 1 to 17 (the runtime-t instantiation but at
    3, 4, 6, 7): the whole solve at N = 40, the tiled and fused solvers
    (float32 and bf16 operands) at N = 53, against their plain versions
    on the same CUDA tensors as test_kernel_matches_plain holds t = 6 (x
    within 1e-4 of max|x| + 1e-5, iterations within one), the launches
    counted (one a solve; the tiled solver one matvec and one apply an
    iteration, CHECK_EVERY at a time, and one apply more), and a second
    run bit-equal."""
    N = 40 if solver == 'whole' else 53
    gen = torch.Generator(device=cuda).manual_seed(100 + t)
    offsets, (b_T, *ops) = random_stencil_system(N, 9, 15, t % 2 == 0, gen,
                                                 cuda, t=t)
    kernel, plain, stored = _any_t_solver(solver, b_T, ops, offsets, t, 300,
                                          1e-7)
    counter = _ANY_T_COUNTER[solver]
    before = getattr(scg, counter), scg.TILED_PC_LAUNCHES
    x_k, it_k = kernel()
    torch.cuda.synchronize()
    launched = getattr(scg, counter) - before[0]
    if solver == 'tiled':
        # one apply more than matvecs (z0), the iterations in batches of
        # CHECK_EVERY
        assert launched + 1 == scg.TILED_PC_LAUNCHES - before[1]
        assert launched >= int(it_k)
    else:
        assert launched == 1
    x_p, it_p = plain(*(a.float() for a in stored), b_T, offsets, t, 300,
                      1e-7)
    err = float((x_k - x_p).abs().max())
    assert err <= 1e-4 * float(x_p.abs().max()) + 1e-5
    assert abs(int(it_k) - int(it_p)) <= 1 and int(it_k) < 300
    x_k2, it_k2 = kernel()
    assert torch.equal(x_k, x_k2) and int(it_k) == int(it_k2)


@pytest.mark.parametrize('t', [3, 4, 6, 7])
@pytest.mark.parametrize('solver', ['whole', 'tiled', 'fused', 'fused_bf16'])
@pytest.mark.parametrize('shape', ['small', 'full'])
def test_any_t_bit_equal_to_templates(cuda, shape, solver, t):
    """The runtime-t instantiation forced at a template's t (any_t=True)
    gives the template's bits and iteration count: the same operations in
    the same order.  Small: N = 40 / 53; full: the whole solve at
    sphere2500's shape, the others at the 100k shape, to 60 iterations."""
    if shape == 'small':
        N, d, loops, fixed, maxiter, tol = (40 if solver == 'whole' else 53,
                                            9, 15, False, 300, 1e-7)
    elif solver == 'whole':
        N, d, loops, fixed, maxiter, tol = 2500, 157, 2000, True, 60, 0.0
    else:
        N, d, loops, fixed, maxiter, tol = 100_000, 993, 80_000, True, 60, 0.0
    gen = torch.Generator(device=cuda).manual_seed(200 + t)
    offsets, (b_T, *ops) = random_stencil_system(N, d, loops, fixed, gen,
                                                 cuda, t=t)
    template, _, _ = _any_t_solver(solver, b_T, ops, offsets, t, maxiter, tol)
    runtime, _, _ = _any_t_solver(solver, b_T, ops, offsets, t, maxiter, tol,
                                  any_t=True)
    x_a, it_a = template()
    x_b, it_b = runtime()
    assert int(it_a) == int(it_b)
    assert torch.equal(x_a, x_b)


@pytest.mark.parametrize('t', [2, 5, 9, 16])
def test_any_t_tiled_kernels_alone(cuda, t):
    """The runtime-t matvec and block-Jacobi kernels alone, one launch
    each, at the 100k shape: within 1e-5 of max|y| (+1e-6) of the plain
    versions, and bit-equal to a second launch."""
    gen = torch.Generator(device=cuda).manual_seed(300 + t)
    offsets, (b_T, A_T, Minv_T, C_T) = random_stencil_system(
        100_000, 993, 80_000, True, gen, cuda, t=t)
    v = torch.randn(b_T.shape, generator=gen, device=cuda)
    for kern, plain in (
            (lambda: scg._tiled_mv_launch(A_T, C_T, v, offsets, t),
             lambda: scg._stencil_matvec_torch(A_T, C_T, offsets, t, v)),
            (lambda: scg._tiled_pc_launch(Minv_T, v, t),
             lambda: scg._block_mul(Minv_T, v, t))):
        y_k, y_p = kern(), plain()
        err = float((y_k - y_p).abs().max())
        assert err <= 1e-5 * float(y_p.abs().max()) + 1e-6
        assert torch.equal(y_k, kern())


# the tiled kernels' shapes: (N, offsets): d = N - 1, d = 0, a d past a
# tile (128 nodes), N % 4 != 0 (its rows start off 16-byte boundaries),
# N below a tile (every window wraps), the 100k shape with d = N - 1
_TILED_SHAPES = {
    'N=40': (40, (39, 9)),
    'N=53': (53, (1, 52, 0)),
    'N=100,000': (100_000, (1, 993, 99_999, 700))}


def _tiled_operands(N, t, n_off, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((t * t, N), generator=gen, device=dev),
            torch.randn((n_off * t * t, N), generator=gen, device=dev),
            torch.randn((t, N), generator=gen, device=dev))


def _hold_tiled(A_T, C_T, v, offsets, t, any_t=False):
    """One launch of each tiled kernel against its plain version, within
    1e-5 of max|y| (+1e-6), and one of the ring matvec (forced at every t)
    bit-equal to the routed matvec, each counted once; returns (q, z)."""
    before = (scg.TILED_MV_LAUNCHES, scg.TILED_PC_LAUNCHES)
    q = scg._tiled_mv_launch(A_T, C_T, v, offsets, t, any_t)
    assert scg.TILED_MV_LAUNCHES == before[0] + 1
    z = scg._tiled_pc_launch(A_T, v, t, any_t)
    assert scg.TILED_PC_LAUNCHES == before[1] + 1
    q_ring = scg._tiled_mv_launch(A_T, C_T, v, offsets, t, ring=True)
    assert scg.TILED_MV_LAUNCHES == before[0] + 2
    torch.cuda.synchronize()
    assert torch.equal(q, q_ring), float((q - q_ring).abs().max())
    for y_k, y_p in ((q, scg._stencil_matvec_torch(A_T, C_T, offsets, t, v)),
                     (z, scg._block_mul(A_T, v, t))):
        err = float((y_k - y_p).abs().max())
        assert err <= 1e-5 * float(y_p.abs().max()) + 1e-6, err
    return q, z


@pytest.mark.parametrize('shape', list(_TILED_SHAPES))
@pytest.mark.parametrize('t', [1, 2, 3, 5, 7, 9, 16, 17])
def test_tiled_kernels_at_every_shape(cuda, t, shape):
    """The tiled matvec and block-Jacobi kernels at the templates' t and at
    runtime t, one launch each, against their plain versions, and the ring
    matvec (persistent CTAs, bulk copies into shared memory) bit-equal to
    the routed one, on windows that wrap at N, start off 16-byte
    boundaries and reach past a tile; counted once a call."""
    N, offsets = _TILED_SHAPES[shape]
    A_T, C_T, v = _tiled_operands(N, t, len(offsets), cuda, seed=500 + t)
    _hold_tiled(A_T, C_T, v, offsets, t)


@pytest.mark.parametrize('t', [2, 7])
def test_tiled_kernels_with_sixteen_offsets(cuda, t):
    """16 offsets (the most the kernels take) at N = 1,001, among them
    d = 0 and d = N - 1, and at N = 53 (every window wraps)."""
    for N in (1001, 53):
        offsets = (0, N - 1) + tuple(range(1, N - 1, (N - 2) // 14))[:14]
        assert len(set(offsets)) == 16
        A_T, C_T, v = _tiled_operands(N, t, 16, cuda, seed=600 + N)
        _hold_tiled(A_T, C_T, v, offsets, t)


@pytest.mark.parametrize('shape', ['N=53', 'N=100,000'])
@pytest.mark.parametrize('t', [3, 4, 6, 7])
def test_tiled_templates_bit_equal_to_any_t(cuda, t, shape):
    """At a template's t the runtime-t kernels (any_t=True) give the
    template's bits, matvec and apply."""
    N, offsets = _TILED_SHAPES[shape]
    A_T, C_T, v = _tiled_operands(N, t, len(offsets), cuda, seed=700 + t)
    q, z = _hold_tiled(A_T, C_T, v, offsets, t)
    q2, z2 = _hold_tiled(A_T, C_T, v, offsets, t, any_t=True)
    assert torch.equal(q, q2) and torch.equal(z, z2)


def test_tiled_kernels_take_views_off_16_byte_boundaries(cuda):
    """Operands that start 4, 8 and 12 bytes past a 16-byte boundary (views
    into larger buffers) and end off one: the windows' aligned supersets
    stay inside the tensors, the floats outside their aligned interiors
    come one by one."""
    N, offsets, t = 53, (1, 52), 5
    A_T, C_T, v = _tiled_operands(N, t, 2, cuda, seed=800)
    views = []
    for shift, a in zip((1, 2, 3), (A_T, C_T, v)):
        buf = torch.full((a.numel() + 8,), float('nan'), device=cuda)
        view = buf[shift:shift + a.numel()].view_as(a)
        view.copy_(a)
        views.append(view)
    q, z = _hold_tiled(*views, offsets, t)
    q2, z2 = _hold_tiled(A_T, C_T, v, offsets, t)
    assert torch.equal(q, q2) and torch.equal(z, z2)


def test_tiled_plan_matches_the_kernels(cuda):
    """ops.stencil_cg.tiled_plan (CPU arithmetic) gives the plan the ring
    kernel computes (ppt_tiled_plan), CTAs included, at t = 1..32 and N of
    each residue mod 4."""
    keys = ('tile_nodes', 'group', 'slab', 'stages', 'row_pitch',
            'forward_pitch', 'back_pitch', 'stage_bytes', 'smem', 'ctas')
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for t in range(1, 33):
        for N in (53, 100_000, 100_001, 100_002, 100_003):
            host = scg.tiled_plan(N, t, 2, sms)
            dev = scg._tiled_plan_on_device(N, t, cuda)
            assert {k: host[k] for k in keys} == dev, (N, t)


@pytest.mark.parametrize('t,smem', [(2, True), (5, True), (8, True),
                                    (9, False), (16, False)])
def test_any_t_whole_solve_at_sphere2500_shape(cuda, t, smem):
    """The whole solve's runtime-t instantiation at sphere2500's shape on
    both sides of its shared-memory switch (operands in shared memory to
    t = 8, in L2 from t = 9), converged and to 60 iterations, against the
    plain version; one launch each."""
    assert scg.stencil_cg_smem_fits(2500, t, 2) == smem
    gen = torch.Generator(device=cuda).manual_seed(400 + t)
    offsets, (b_T, *ops) = random_stencil_system(2500, 157, 2000, True, gen,
                                                 cuda, t=t)
    for maxiter, tol in ((500, 1e-6), (60, 0.0)):
        before = scg.LAUNCHES
        x_k, it_k = scg.stencil_cg_transposed(b_T, *ops, offsets, t, maxiter,
                                              tol)
        torch.cuda.synchronize()
        assert scg.LAUNCHES == before + 1
        x_p, it_p = scg._cg_body_torch(*ops, b_T, offsets, t, maxiter, tol)
        err = float((x_k - x_p).abs().max())
        assert err <= 1e-4 * float(x_p.abs().max()) + 1e-5
        assert abs(int(it_k) - int(it_p)) <= 1


@pytest.mark.parametrize('t', [1, 2, 5, 9, 16])
def test_any_t_ring_card_matches_cpu(cuda, t):
    """ring3_problem at block size t: route 'stencil' through the
    whole-solve kernel's runtime-t instantiation on the card (one launch a
    solve), chi2 within 1e-4 of the CPU's over two steps."""
    from pypose_tpu_torch.optim.sparse import SparseLM
    from pypose_tpu_torch.optim.strategy import TrustRegion
    from pypose_tpu_torch.testing import ring3_problem

    def make(dev):
        params, factors, fixed = ring3_problem(device=dev, t=t)
        return SparseLM(params, factors, strategy=TrustRegion(radius=1e4),
                        fixed=fixed, cg_iter=100, cg_tol=1e-8)
    card, cpu = _steps_card_and_cpu(make, 2, route='stencil')
    assert max(abs(a / b - 1) for a, b in zip(card, cpu)) <= 1e-4


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


@pytest.mark.parametrize('kind', ['6x10', '6x6-rank4'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_lstsq_on_card_is_the_minimum_norm_answer(cuda, kind, dtype):
    """LSTSQ on CUDA (the SVD minimum-norm route; torch's CUDA lstsq has
    only gels) against the CPU route (gelsy, held to the JAX package by
    test_torch_keywords_lstsq.py) on 5 systems of EPnP's N = 4 shape and
    5 of exact rank 4 (integer factors): within 1e-5 (float32) and 1e-10
    (float64) of (1 + magnitude), and orthogonal to the null space."""
    import numpy as np
    from pypose_tpu_torch.optim.solver import LSTSQ
    rng = np.random.default_rng(0)
    A = rng.normal(size=(5, 6, 10)) if kind == '6x10' else \
        rng.integers(-3, 4, size=(5, 6, 4)) @ rng.integers(-3, 4,
                                                         size=(5, 4, 6))
    A = torch.tensor(A, dtype=dtype)
    b = torch.tensor(rng.normal(size=(5, 6)), dtype=dtype)
    want = LSTSQ()(A, b)
    got = LSTSQ()(A.to(cuda), b.to(cuda)).cpu()
    tol = (1e-5 if dtype == torch.float32 else 1e-10) * \
        (1 + float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol
    _, _, Vh = torch.linalg.svd(A)
    null = Vh[..., 4:, :] if kind != '6x10' else Vh[..., 6:, :]
    assert float((null @ got[..., None]).abs().max()) <= tol


@pytest.mark.parametrize('refine', [False, True])
def test_epnp_card_matches_cpu(cuda, refine):
    """EPnP on the card against the CPU on the same float32 instance (64
    problems, or 8 refined), held by testing.epnp_failures (each pose
    within 2 (e_card + e_cpu) + 1e-6, at most one candidate flip); no
    kernel launched."""
    from pypose_tpu_torch.testing import (epnp_failures, epnp_instance,
                                          epnp_solve, epnp_stats)
    B = 8 if refine else 64
    cpu = epnp_solve(epnp_instance(B, seed=1, device='cpu'), refine)
    before = dict(scg=scg.LAUNCHES, knn=knn.NN1_LAUNCHES + knn.NNK_LAUNCHES)
    card = epnp_solve(epnp_instance(B, seed=1, device=cuda), refine)
    assert before == dict(scg=scg.LAUNCHES,
                          knn=knn.NN1_LAUNCHES + knn.NNK_LAUNCHES)
    ref = {'stats': epnp_stats(cpu[2]), 'candidates': cpu[1],
           'poses': cpu[0], 'errors': cpu[2]}
    bad, numbers = epnp_failures('epnp', ref, *card)
    assert not bad, (bad, numbers)


# ---------------------------------------------------------------------------
# trajectory metrics, splines, block-sparse products, Timer, checkpoints
# (no kernel on their paths)
# ---------------------------------------------------------------------------

def test_metric_card_matches_cpu(cuda):
    """testing.EUROC_METRICS on a tenth of the EuRoC-like instance (3,600
    reference and 360 estimated poses) and testing.SPHERE_METRICS on the
    2,500-pose synthetic sphere graph (ground truth against the initial
    poses): the card's statistics against the CPU's within
    testing.METRIC_ATOL + METRIC_RTOL |value|."""
    import numpy as np
    from pypose_tpu_torch.datasets import synthetic_sphere
    from pypose_tpu_torch.metric import ape, rpe
    from pypose_tpu_torch.testing import (EUROC_METRICS, SPHERE_METRICS,
                                          euroc_instance, metric_failures,
                                          metric_stats)
    fns = {'ape': ape, 'rpe': rpe}
    stats = {}
    for dev in ('cpu', cuda):
        d = euroc_instance(3_600, 360, device=dev)
        ds = synthetic_sphere(2500, device=dev)
        stamps = np.arange(2500, dtype=np.float64)
        stats[str(dev)] = (
            metric_stats(fns, EUROC_METRICS, d['rstamp'], d['rpose'],
                         d['estamp'], d['epose']),
            metric_stats(fns, SPHERE_METRICS, stamps, ds['gt'], stamps,
                         ds['nodes']))
    for want, got in zip(stats['cpu'], stats[str(cuda)]):
        bad, _ = metric_failures(want, got)
        assert not bad, bad


def test_svdstf_reflection_card_matches_cpu(cuda):
    """svdstf (cuSOLVER's SVD on the card) on a planar cloud mirrored in
    z (det(U V) = -1 without the sign fix) and on a plain one: the card's
    Sim3 within 1e-5 of the CPU's, a proper rotation either way."""
    from pypose_tpu_torch.function.geometry import svdstf
    gen = torch.Generator().manual_seed(0)
    src = torch.randn(200, 3, generator=gen)
    src[:, 2] *= 1e-3
    T = svdstf(src, src * torch.tensor([1.3, 1.3, 1.3]))
    mirrored = src * torch.tensor([1., 1., -1.]) + torch.tensor([1., 2., 3.])
    for tgt in (mirrored, 2.0 * src + 0.5):
        want = svdstf(src, tgt).tensor()
        got = svdstf(src.to(cuda), tgt.to(cuda)).tensor().cpu()
        assert float((got - want).abs().max()) <= 1e-5, (got, want)
        assert abs(float(got[3:7].norm()) - 1) < 1e-5
    assert abs(float(T.tensor()[7]) - 1.3) < 1e-4


def test_splines_card_match_cpu(cuda):
    """bspline (with and without extrapolate) and chspline over 2,000
    control poses and waypoints of testing.spline_instance: the card's
    outputs held to the CPU's by testing.spline_failures."""
    import pypose_tpu_torch as ppt
    from pypose_tpu_torch.testing import (spline_failures, spline_instance,
                                          spline_summary)
    out = {}
    for dev in ('cpu', cuda):
        d = spline_instance(2_000, device=dev)
        out[str(dev)] = [spline_summary(x, every=37) for x in (
            ppt.bspline(d['poses'], 0.1),
            ppt.bspline(d['poses'], 0.1, extrapolate=True),
            ppt.chspline(d['points'], 0.1))]
    for want, got in zip(out['cpu'], out[str(cuda)]):
        bad, _ = spline_failures(want, got)
        assert not bad, bad


def test_bsr_products_deterministic_on_card(cuda):
    """E = J_c^T J_p of synthetic_bal(16, 300) (testing.bsr_instance):
    bsr_bsc_matmul(E, E^T) and bsr_matvec on the card, two runs bit for
    bit, within 1e-5 of scipy's float64 product (entrywise, of |E| |E|^T)
    and of the CPU's result."""
    import numpy as np
    from pypose_tpu_torch.datasets import synthetic_bal
    from pypose_tpu_torch.sparse import bsr_bsc_matmul, bsr_matvec
    from pypose_tpu_torch.testing import bsr_instance, bsr_reference
    res = {}
    for dev in ('cpu', cuda):
        m = bsr_instance(synthetic_bal(16, 300, device=dev))
        x = torch.linspace(-1, 1, m['E'].shape[1], device=dev)
        res[str(dev)] = (m, bsr_bsc_matmul(m['E'], m['Et']),
                         bsr_matvec(m['E'], x))
        if dev == cuda:
            assert torch.equal(res[str(dev)][1],
                               bsr_bsc_matmul(m['E'], m['Et']))
            assert torch.equal(res[str(dev)][2], bsr_matvec(m['E'], x))
    m = res['cpu'][0]
    ref = bsr_reference(m['E'])
    absE = m['E']._replace(values=m['E'].values.abs())
    scale = bsr_reference(absE)
    for dev in ('cpu', str(cuda)):
        got = res[dev][1].cpu().double().numpy()
        assert (np.abs(got - ref) <= 1e-5 * np.maximum(scale, 1e-30)).all()
    mv_gap = (res[str(cuda)][2].cpu() - res['cpu'][2]).abs().max()
    assert float(mv_gap) <= 1e-5 * float(res['cpu'][2].abs().max())


def test_timer_waits_for_the_card(cuda):
    """Timer() (the card by default) measures the queued work: at least
    0.9 of the CUDA-event time of the same 20 matmuls."""
    from pypose_tpu_torch.utils import Timer
    a = torch.randn(4096, 4096, device=cuda)

    def work():
        for _ in range(20):
            a @ a
    work()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    work()
    end.record()
    torch.cuda.synchronize()
    event_s = start.elapsed_time(end) / 1e3
    t = Timer()
    work()
    assert t.toc() >= 0.9 * event_s
    assert t.device.type == 'cuda'


def test_checkpoint_from_card_loads_on_card(cuda, tmp_path):
    """A tree of card tensors and LieTensors saved and loaded: on the card
    by default, on the CPU when asked, the same values and ltypes."""
    import os
    import pypose_tpu_torch as ppt
    from pypose_tpu_torch.utils import checkpoint
    g = torch.Generator().manual_seed(0)
    tree = {'T': ppt.randn_SE3(4, generator=g, device=cuda),
            'x': torch.arange(5.0, device=cuda),
            'l': [ppt.randn_Sim3(2, generator=g, device=cuda), 3, 'a'],
            't': (torch.ones(2, dtype=torch.float64, device=cuda),)}
    path = os.path.join(str(tmp_path), 'state')
    checkpoint.save(path, tree)
    back = checkpoint.load(path)
    assert back['T'].device.type == 'cuda' and back['T'].ltype is \
        ppt.SE3_type
    assert torch.equal(back['T'].tensor(), tree['T'].tensor())
    assert torch.equal(back['x'], tree['x'])
    assert back['l'][0].ltype is ppt.Sim3_type and back['l'][1:] == [3, 'a']
    assert back['t'][0].dtype == torch.float64
    cpu = checkpoint.load(path, device='cpu')
    assert cpu['T'].device.type == 'cpu'


def test_imu_state_and_voxel_given_on_another_device(cuda):
    """IMUPreintegrator(vel=a CPU tensor, device=the card) integrates card
    inputs (the given state moves to ``device``), and voxel_filter takes
    its voxel size as a card tensor: both as on the CPU."""
    from pypose_tpu_torch.function.geometry import voxel_filter
    from pypose_tpu_torch.module import IMUPreintegrator
    dt = torch.full((1, 20, 1), 0.01)
    gyro = torch.tensor([0., 0., 0.5]).expand(1, 20, 3)
    acc = torch.tensor([0., 1.25, 9.81007]).expand(1, 20, 3)
    vel = torch.tensor([2.5, 0., 0.])
    want = IMUPreintegrator(vel=vel, reset=True)(dt, gyro, acc)['pos']
    got = IMUPreintegrator(vel=vel, reset=True, device=cuda)(
        dt.to(cuda), gyro.to(cuda), acc.to(cuda))['pos']
    assert float((got.cpu() - want).abs().max()) <= 1e-5
    pts = torch.rand(500, 3, generator=torch.Generator().manual_seed(0))
    want = voxel_filter(pts, torch.tensor([0.2, 0.2, 0.2]))
    got = voxel_filter(pts.to(cuda), torch.tensor([0.2, 0.2, 0.2],
                                                  device=cuda))
    assert got.device.type == 'cuda'
    assert torch.equal(got.cpu(), want)

