"""The port's tiled stencil CG (the route past the whole-solve kernel's L2
budget): its plain version on the CPU against the JAX package's
stencil_cg_tiled in interpret mode and _cg_body, against a dense solve in
float64, through stencil_cg with fixed nodes, and the device-side stop
test against the host-read one.  The CUDA kernels' own tests are in
test_torch_cuda.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pypose_tpu.ops.pallas_cg import _cg_body as jax_cg_body
from pypose_tpu.ops.pallas_cg import stencil_cg as jax_stencil_cg
from pypose_tpu.ops.pallas_cg import stencil_cg_tiled as jax_stencil_cg_tiled
from pypose_tpu.ops.spmv import StencilSpMV as JStencil
from pypose_tpu_torch.ops import stencil_cg as scg
from pypose_tpu_torch.ops.spmv import StencilSpMV

from test_torch_stencil_cg import make_system


def f64_system(N, seed):
    """make_system's system in float64, the diagonal blocks summed in
    float64 from the same Jacobians, so that the operands and the dense
    matrix are the same system to rounding."""
    edges, J, D, dcorr, Minv, b, A_dense = make_system(N, seed=seed)
    J = J.astype(np.float64)
    D = np.zeros(D.shape)
    for a in range(2):
        np.add.at(D, edges[:, a], np.einsum('edt,edu->etu', J[:, :, a],
                                            J[:, :, a]))
    return (edges, J, D, dcorr.astype(np.float64), Minv.astype(np.float64),
            b.astype(np.float64), A_dense)


def lane_major(edges, J, D, dcorr, Minv, b):
    """Folded lane-major operands (no fixed nodes) as numpy, for both
    packages: (b_T, A_T, Minv_T, C_T, offsets)."""
    N, t = b.shape
    sp = StencilSpMV(edges, N, t)
    C = sp.precompute(torch.from_numpy(J), torch.from_numpy(J)).numpy()
    A = D + dcorr[..., None] * np.eye(t, dtype=D.dtype)
    return (np.ascontiguousarray(b.T),
            np.ascontiguousarray(np.transpose(A, (1, 2, 0)).reshape(t * t, N)),
            np.ascontiguousarray(np.transpose(Minv, (1, 2, 0))
                                 .reshape(t * t, N)),
            np.ascontiguousarray(np.transpose(C, (0, 2, 3, 1))
                                 .reshape(-1, N)),
            tuple(sp.offsets))


def test_tiled_matches_jax_tiled_and_cg_body():
    """N=53 (ragged against JAX's 16-wide tiles, offsets wrap): x within
    rtol 1e-4 / atol 1e-5 of both JAX solvers (float32, sums in another
    order) and iterations within one."""
    *ops, offsets = lane_major(*make_system(53, seed=5)[:6])
    t = 6
    x_t, it_t = scg.stencil_cg_tiled(*map(torch.from_numpy, ops), offsets, t,
                                     200, 1e-7)
    b_T, A_T, Minv_T, C_T = map(jnp.asarray, ops)
    x_jt, it_jt = jax_stencil_cg_tiled(b_T, A_T, Minv_T, C_T, offsets, t, 200,
                                       1e-7, tile=16, interpret=True)
    x_jb, it_jb = jax_cg_body(A_T, Minv_T, C_T, b_T, offsets, t, 200, 1e-7)
    for x_j, it_j in ((x_jt, it_jt), (x_jb, it_jb)):
        np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-4,
                                   atol=1e-5)
        assert abs(int(it_t) - int(it_j)) <= 1
    assert int(it_t) < 200


@pytest.mark.parametrize('N', [40, 53])
def test_tiled_matches_dense_solve_f64(N):
    """float64: the converged solve (|r| <= 1e-12 |b|) within rtol 1e-7 of
    numpy's dense solve; these systems' condition numbers are below 1e4."""
    edges, J, D, dcorr, Minv, b, A_dense = f64_system(N, N + 1)
    assert np.linalg.cond(A_dense) < 1e4
    *ops, offsets = lane_major(edges, J, D, dcorr, Minv, b)
    x, it = scg.stencil_cg_tiled(*map(torch.from_numpy, ops), offsets, 6,
                                 1000, 1e-12)
    assert x.dtype == torch.float64 and int(it) < 1000
    x_ref = np.linalg.solve(A_dense, b.reshape(-1)).reshape(N, 6)
    np.testing.assert_allclose(x.numpy().T, x_ref, rtol=1e-7, atol=1e-9)


def test_stencil_cg_tiled_route_with_fixed_mask(monkeypatch):
    """stencil_cg forced past the budget, with the tiled solver in the
    oversize route's place (the fused solver's), folds the fixed node and
    solves on the tiled route: x within rtol 1e-4 / atol 1e-5 of JAX
    stencil_cg(use_pallas=False), iterations within one, node 0 exactly
    zero."""
    edges, J, D, dcorr, Minv, b, _ = make_system(53, seed=2)
    N, t = b.shape
    mask = np.zeros(N, bool)
    mask[0] = True
    calls = []
    plain = scg._tiled_cg_torch
    monkeypatch.setattr(scg, 'stencil_cg_fits', lambda *a: False)
    monkeypatch.setattr(scg, 'stencil_cg_fused', scg.stencil_cg_tiled)
    monkeypatch.setattr(scg, '_tiled_cg_torch',
                        lambda *a: calls.append(a) or plain(*a))
    ts = StencilSpMV(edges, N, t)
    x_t, it_t = scg.stencil_cg(
        torch.from_numpy(b), torch.from_numpy(D), torch.from_numpy(dcorr),
        torch.from_numpy(Minv),
        ts.precompute(torch.from_numpy(J), torch.from_numpy(J)),
        tuple(ts.offsets), fixed_mask=torch.from_numpy(mask), maxiter=400,
        tol=1e-7)
    assert len(calls) == 1
    js = JStencil(edges, N, t)
    x_j, it_j = jax_stencil_cg(
        jnp.asarray(b), jnp.asarray(D), jnp.asarray(dcorr), jnp.asarray(Minv),
        js.precompute(jnp.asarray(J), jnp.asarray(J)), tuple(js.offsets),
        fixed_mask=jnp.asarray(mask), maxiter=400, tol=1e-7,
        use_pallas=False)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-4,
                               atol=1e-5)
    assert abs(int(it_t) - int(it_j)) <= 1
    np.testing.assert_array_equal(x_t[0].numpy(), 0.0)


@pytest.mark.parametrize('maxiter', [0, 1, 7, 8, 9, 13, 400])
def test_device_stop_test_matches_host_loop(maxiter):
    """The stop flag evaluated on the device, read every CHECK_EVERY
    iterations, gives the while_loop's iteration count and x (the
    whole-solve plain version reads |r|^2 every iteration): same count,
    x within 1e-6 (float32; one dot is torch.dot, the other a sum)."""
    *ops, offsets = lane_major(*make_system(40, seed=9)[:6])
    b_T, A_T, Minv_T, C_T = map(torch.from_numpy, ops)
    x_t, it_t = scg.stencil_cg_tiled(b_T, A_T, Minv_T, C_T, offsets, 6,
                                     maxiter, 1e-6)
    x_h, it_h = scg._cg_body_torch(A_T, Minv_T, C_T, b_T, offsets, 6, maxiter,
                                   1e-6)
    assert int(it_t) == int(it_h) == min(maxiter, int(it_h))
    np.testing.assert_allclose(x_t.numpy(), x_h.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_tiled_zero_rhs_and_shape_checks():
    N, t = 10, 6
    z = torch.zeros
    ok = (z(t, N), z(t * t, N), z(t * t, N), z(2 * t * t, N))
    x, it = scg.stencil_cg_tiled(*ok, (1, 3), t, 5, 1e-5)
    assert x.shape == (t, N) and int(it) == 0  # b = 0 stops at once
    with pytest.raises(ValueError, match='C_T has shape'):
        scg.stencil_cg_tiled(*ok[:3], z(t * t, N), (1, 3), t, 5, 1e-5)


def test_tiled_f64_matches_jax_x64():
    """float64 on both sides (jax x64): the tiled plain version against
    JAX's _cg_body to rtol 1e-9 at 60 iterations."""
    *ops, offsets = lane_major(*f64_system(53, 4)[:6])
    x_t, it_t = scg.stencil_cg_tiled(*map(torch.from_numpy, ops), offsets, 6,
                                     60, 0.0)
    with jax.enable_x64(True):
        b_T, A_T, Minv_T, C_T = map(jnp.asarray, ops)
        x_j, it_j = jax_cg_body(A_T, Minv_T, C_T, b_T, offsets, 6, 60, 0.0)
        x_j = np.asarray(x_j)
    assert int(it_t) == int(it_j) == 60
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize('t', [3, 4, 7])
def test_tiled_matches_jax_tiled_at_block_size(t):
    """Block sizes 3, 4 and 7 at N=53: the tiled plain version against the
    JAX package's stencil_cg_tiled in interpret mode and its _cg_body, x
    within rtol 1e-4 / atol 1e-5, iterations within one."""
    *ops, offsets = lane_major(*make_system(53, t=t, seed=5 + t)[:6])
    x_t, it_t = scg.stencil_cg_tiled(*map(torch.from_numpy, ops), offsets, t,
                                     200, 1e-7)
    b_T, A_T, Minv_T, C_T = map(jnp.asarray, ops)
    x_jt, it_jt = jax_stencil_cg_tiled(b_T, A_T, Minv_T, C_T, offsets, t, 200,
                                       1e-7, tile=16, interpret=True)
    x_jb, it_jb = jax_cg_body(A_T, Minv_T, C_T, b_T, offsets, t, 200, 1e-7)
    for x_j, it_j in ((x_jt, it_jt), (x_jb, it_jb)):
        np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-4,
                                   atol=1e-5)
        assert abs(int(it_t) - int(it_j)) <= 1
    assert int(it_t) < 200
    assert tuple(x_t.shape) == (t, 53)
