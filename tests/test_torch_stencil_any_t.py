"""The stencil PCG at block sizes outside {3, 4, 6, 7}, which the CUDA
kernels take through their runtime-t instantiation: the plain whole-solve,
tiled and fused versions on the CPU against the JAX package's Pallas
kernels in interpret mode, with and without a fixed node; SparseLM's
'stencil' route over a Euclidean ring factor of t coordinates against the
JAX package's SparseLM; and the budgets that pick where each kernel keeps
its operands, on both sides of their switches.  The kernels' own tests
are in test_torch_cuda.py.

Tolerances.  The solvers: x within rtol 1e-4 / atol 1e-5 of JAX's and
iterations within one (float32, sums in another order), as
tests/test_torch_stencil_cg.py holds t = 3, 4 and 7; the whole solve also
within 5e-3 of numpy's dense solve.  SparseLM: chi2 per step within rtol
1e-4 and the points within atol 1e-5, as test_c3_ring3_matches_jax holds
t = 3.  The third LM step from ring3_problem's start sits at the float32
noise floor: the reduction it predicts is ~1e-7 of chi2, the size of
chi2's own rounding, so whether it is accepted, and how far it moves,
differs between the packages (measured at t = 16: the port 7.8e-5 from a
float64 run of the same three steps, JAX 2.4e-7; at t = 1 the other way
round, 2.4e-5 against 1.5e-7; both within 3.6e-7 of each other after two
steps).  After the third step the points are held within atol 1e-5 plus
the longer of the two packages' third steps.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pypose_tpu.ops.pallas_cg import stencil_cg as jax_stencil_cg
from pypose_tpu.ops.pallas_cg import stencil_cg_fused as jax_stencil_cg_fused
from pypose_tpu.ops.pallas_cg import stencil_cg_tiled as jax_stencil_cg_tiled
from pypose_tpu.ops.spmv import StencilSpMV as JStencil
from pypose_tpu_torch.ops import stencil_cg as scg
from pypose_tpu_torch.ops.spmv import StencilSpMV
from pypose_tpu_torch.optim import sparse as tsp
from pypose_tpu_torch.optim.strategy import TrustRegion
from pypose_tpu_torch.testing import cap_threads, ring3_problem

from test_torch_sparse_lm_general import jax_ring3
from test_torch_stencil_cg import make_system

cap_threads()

# block sizes without a template: 1, 2, 5 below and between the groups',
# 8 / 9 on either side of the whole solve's shared-memory switch at
# sphere2500's shape, 12 / 16 / 17 past the tangent dimensions in use
ANY_T = (1, 2, 5, 8, 9, 12, 16, 17)


def folded(N, t, fixed, seed):
    """make_system's system folded into lane-major operands (node 0 fixed
    if ``fixed``), as numpy for both packages: (b_T, A_T, Minv_T, C_T),
    offsets."""
    edges, J, D, dcorr, Minv, b, _ = make_system(N, t=t, seed=seed)
    sp = StencilSpMV(edges, N, t)
    mask = torch.zeros(N, dtype=torch.bool)
    mask[0] = fixed
    offsets = tuple(sp.offsets)
    ops = scg.fold_operands(
        *map(torch.from_numpy, (b, D, dcorr, Minv)),
        sp.precompute(torch.from_numpy(J), torch.from_numpy(J)), offsets,
        mask)
    return tuple(a.numpy() for a in ops), offsets


def assert_solves_agree(x_t, it_t, x_j, it_j, maxiter):
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-4,
                               atol=1e-5)
    assert abs(int(it_t) - int(it_j)) <= 1
    assert int(it_t) < maxiter


@pytest.mark.parametrize('fixed', [False, True])
@pytest.mark.parametrize('t', ANY_T)
def test_whole_solve_matches_jax_kernel(t, fixed):
    """stencil_cg (the whole-solve plain version at N = 40) against the
    JAX package's stencil_cg with its Pallas kernel in interpret mode;
    both within 5e-3 of the dense solve."""
    from jax.experimental.pallas import tpu as pltpu
    N = 40
    edges, J, D, dcorr, Minv, b, A_dense = make_system(N, t=t, seed=30 + t)
    mask = np.zeros(N, bool)
    mask[0] = fixed
    assert scg.stencil_cg_fits(N, t, 2)
    js = JStencil(edges, N, t)
    with pltpu.force_tpu_interpret_mode():
        x_j, it_j = jax_stencil_cg(
            jnp.asarray(b), jnp.asarray(D), jnp.asarray(dcorr),
            jnp.asarray(Minv), js.precompute(jnp.asarray(J), jnp.asarray(J)),
            tuple(js.offsets), fixed_mask=jnp.asarray(mask) if fixed else None,
            maxiter=400, tol=1e-7, use_pallas=True)
    ts = StencilSpMV(edges, N, t)
    x_t, it_t = scg.stencil_cg(
        *map(torch.from_numpy, (b, D, dcorr, Minv)),
        ts.precompute(torch.from_numpy(J), torch.from_numpy(J)),
        tuple(ts.offsets),
        fixed_mask=torch.from_numpy(mask) if fixed else None, maxiter=400,
        tol=1e-7)
    assert tuple(x_t.shape) == (N, t)
    assert_solves_agree(x_t, it_t, x_j, it_j, 400)
    keep = np.ones(N * t, bool)
    keep[:t] = not fixed
    x_ref = np.linalg.solve(A_dense[np.ix_(keep, keep)], b.reshape(-1)[keep])
    np.testing.assert_allclose(x_t.numpy().reshape(-1)[keep], x_ref,
                               rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize('fixed', [False, True])
@pytest.mark.parametrize('t', ANY_T)
def test_tiled_matches_jax_tiled(t, fixed):
    """stencil_cg_tiled's plain version at N = 53 (ragged against JAX's
    16-wide tiles, offsets wrap) against the JAX package's
    stencil_cg_tiled in interpret mode."""
    ops, offsets = folded(53, t, fixed, 40 + t)
    x_t, it_t = scg.stencil_cg_tiled(*map(torch.from_numpy, ops), offsets, t,
                                     200, 1e-7)
    x_j, it_j = jax_stencil_cg_tiled(*map(jnp.asarray, ops), offsets, t, 200,
                                     1e-7, tile=16, interpret=True)
    assert tuple(x_t.shape) == (t, 53)
    assert_solves_agree(x_t, it_t, x_j, it_j, 200)


@pytest.mark.parametrize('fixed', [False, True])
@pytest.mark.parametrize('t', ANY_T)
def test_fused_matches_jax_fused(t, fixed):
    """stencil_cg_fused's plain version (float32 operands) at N = 53
    against the JAX package's stencil_cg_fused in interpret mode."""
    ops, offsets = folded(53, t, fixed, 50 + t)
    x_t, it_t = scg.stencil_cg_fused(*map(torch.from_numpy, ops), offsets, t,
                                     200, 1e-7)
    x_j, it_j = jax_stencil_cg_fused(*map(jnp.asarray, ops), offsets, t, 200,
                                     1e-7, tile=16, interpret=True)
    assert_solves_agree(x_t, it_t, x_j, it_j, 200)


@pytest.mark.parametrize('t', [2, 9, 16])
def test_fused_bf16_matches_jax_fused_bf16(t):
    """bf16 operand storage on both sides (each rounds A, Minv, C to
    nearest even and computes in float32), N = 53, node 0 fixed."""
    ops, offsets = folded(53, t, True, 60 + t)
    x_t, it_t = scg.stencil_cg_fused(*map(torch.from_numpy, ops), offsets, t,
                                     200, 1e-7, operand_dtype=torch.bfloat16)
    x_j, it_j = jax_stencil_cg_fused(*map(jnp.asarray, ops), offsets, t, 200,
                                     1e-7, tile=16, interpret=True,
                                     operand_dtype=jnp.bfloat16)
    assert x_t.dtype == torch.float32
    assert_solves_agree(x_t, it_t, x_j, it_j, 200)


@pytest.mark.parametrize('t', [1, 2, 5, 9, 16])
def test_ring_sparse_lm_matches_jax(t):
    """ring3_problem(N = 64) at block size t in float32: route 'stencil'
    (on the card, the kernels' runtime-t instantiation), three LM steps
    against the JAX package's SparseLM on the same arrays (see the module
    docstring for the third step)."""
    params, factors, fixed = ring3_problem(device='cpu', t=t)
    topt = tsp.SparseLM(params, factors, strategy=TrustRegion(radius=1e4),
                        fixed=fixed, cg_iter=100, cg_tol=1e-8)
    assert topt.route == 'stencil'
    jopt = jax_ring3(params, factors, fixed)
    xs_t, xs_j, hist_t, hist_j = [], [], [], []
    for _ in range(3):
        hist_t.append(topt.step())
        hist_j.append(jopt.step())
        xs_t.append(topt.params['x'].numpy().copy())
        xs_j.append(np.asarray(jopt.params['x']))
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-4)
    for x_t, x_j in zip(xs_t[:2], xs_j[:2]):
        np.testing.assert_allclose(x_t, x_j, atol=1e-5)
    third = max(np.abs(xs_t[2] - xs_t[1]).max(),
                np.abs(xs_j[2] - xs_j[1]).max())
    assert np.abs(xs_t[2] - xs_j[2]).max() <= 1e-5 + third


@pytest.mark.parametrize('t', [1, 5, 9, 16])
def test_ring_float64_takes_einsum(t):
    """float64 stays on 'einsum' at every t, as at t = 3."""
    params, factors, fixed = ring3_problem(device='cpu', t=t,
                                           dtype=torch.float64)
    assert tsp.SparseLM(params, factors, fixed=fixed).route == 'einsum'


@pytest.mark.parametrize('t,smem_bytes,smem', [
    (8, 206_496, True), (9, 254_852, False)])
def test_whole_solve_smem_switch(t, smem_bytes, smem):
    """sphere2500's shape (N = 2500, NL = 157, 2 offsets): the operands
    stay in shared memory up to t = 8, 4 (128 + 157 (9t + 4tt)) bytes a
    CTA within 232,448; from t = 9 they stay in L2, and the state alone,
    4 (128 + 157 (2t + 2t)) bytes, fits shared memory."""
    assert 4 * (128 + 157 * (9 * t + 4 * t * t)) == smem_bytes
    assert scg.stencil_cg_smem_fits(2500, t, 2) == smem == (
        smem_bytes <= scg.SMEM_PER_BLOCK)
    assert scg.stencil_cg_fits(2500, t, 2)
    assert 4 * (128 + 157 * 4 * t) <= scg.SMEM_PER_BLOCK


@pytest.mark.parametrize('t,l2_bytes,fits', [
    (16, 10_880_000, True), (24, 24_000_000, True), (25, 26_000_000, False)])
def test_whole_solve_l2_switch(t, l2_bytes, fits):
    """sphere2500's shape: the whole solve keeps its operands in L2 up to
    t = 24, 4 N (4t + 4tt) bytes within 25e6; past it stencil_cg takes the
    fused solver."""
    assert 4 * 2500 * (4 * t + 4 * t * t) == l2_bytes
    assert scg.stencil_cg_fits(2500, t, 2) == fits == (l2_bytes <= 25e6)
    assert not scg.stencil_cg_smem_fits(2500, t, 2)


@pytest.mark.parametrize('t,nodes_in_smem', [(6, 805), (7, 637), (8, 517),
                                             (9, 429)])
def test_fused_smem_nodes(t, nodes_in_smem):
    """The fused kernel's shared-memory mode (csrc/stencil_cg_fused.cu:
    make_plan, read through fused_plan on the card) holds 6t + tt floats a
    node within 232,448 - 512 bytes a CTA: the 100k shape's 758 nodes a
    CTA on 132 SMs fit up to t = 6; at t = 8 a CTA holds up to 517 nodes,
    at t = 9 429 (the card tests hold fused_plan on both sides)."""
    assert (scg.SMEM_PER_BLOCK - 512) // (4 * (6 * t + t * t)) \
        == nodes_in_smem
    assert (nodes_in_smem >= 758) == (t <= 6)


def test_template_t_routes_nothing():
    """TEMPLATE_T names the block sizes with a compile-time instantiation;
    the route and the wrappers take every t >= 1, and the plain versions
    refuse nothing on the CPU."""
    assert scg.TEMPLATE_T == {3, 4, 6, 7}
    assert not hasattr(scg, 'KERNEL_T')
    ops, offsets = folded(40, 5, True, 0)
    for solver in (scg.stencil_cg_transposed, scg.stencil_cg_tiled,
                   scg.stencil_cg_fused):
        x, it = solver(*map(torch.from_numpy, ops), offsets, 5, 3, 1e-7)
        assert tuple(x.shape) == (5, 40) and int(it) == 3
