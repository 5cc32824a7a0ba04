"""The port's fused (Chronopoulos-Gear) stencil CG: its plain version on
the CPU against the JAX package's stencil_cg_fused, whose Pallas passes
run here in interpret mode (their SMEM dot accumulators included), with
float32 and with bf16 operand storage, against a dense solve in float64,
and against the tiled solver at the 100k-pose shape.  The CUDA kernel's
own tests are in test_torch_cuda.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pypose_tpu.ops.pallas_cg import _cg_body as jax_cg_body
from pypose_tpu.ops.pallas_cg import stencil_cg_fused as jax_stencil_cg_fused
from pypose_tpu_torch.ops import stencil_cg as scg
from pypose_tpu_torch.testing import random_stencil_system

from test_torch_stencil_cg_tiled import f64_system, lane_major
from test_torch_stencil_cg import make_system
from pypose_tpu_torch.testing import cap_threads

cap_threads()


@pytest.mark.parametrize('seed', [5, 6])
def test_fused_matches_jax_fused(seed):
    """N=53 (ragged against JAX's 16-wide tiles, offsets wrap): x within
    rtol 1e-4 / atol 1e-5 of JAX's fused solver in interpret mode and of
    its _cg_body (float32, another recursion and summation order),
    iterations within one."""
    *ops, offsets = lane_major(*make_system(53, seed=seed)[:6])
    x_t, it_t = scg.stencil_cg_fused(*map(torch.from_numpy, ops), offsets, 6,
                                     200, 1e-7)
    b_T, A_T, Minv_T, C_T = map(jnp.asarray, ops)
    x_jf, it_jf = jax_stencil_cg_fused(b_T, A_T, Minv_T, C_T, offsets, 6, 200,
                                       1e-7, tile=16, interpret=True)
    x_jb, it_jb = jax_cg_body(A_T, Minv_T, C_T, b_T, offsets, 6, 200, 1e-7)
    for x_j, it_j in ((x_jf, it_jf), (x_jb, it_jb)):
        np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-4,
                                   atol=1e-5)
        assert abs(int(it_t) - int(it_j)) <= 1
    assert int(it_t) < 200


@pytest.mark.parametrize('seed', [5, 6])
def test_fused_bf16_matches_jax_fused_bf16(seed):
    """bf16 operand storage (operand_dtype) on both sides, N=53: each
    rounds A, Minv and C to bf16 (round to nearest even) and computes in
    float32; x within rtol 1e-4 / atol 1e-5 of JAX's fused solver in
    interpret mode, iterations within one."""
    *ops, offsets = lane_major(*make_system(53, seed=seed)[:6])
    x_t, it_t = scg.stencil_cg_fused(*map(torch.from_numpy, ops), offsets, 6,
                                     200, 1e-7, operand_dtype=torch.bfloat16)
    x_j, it_j = jax_stencil_cg_fused(*map(jnp.asarray, ops), offsets, 6, 200,
                                     1e-7, tile=16, interpret=True,
                                     operand_dtype=jnp.bfloat16)
    assert x_t.dtype == torch.float32
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-4,
                               atol=1e-5)
    assert abs(int(it_t) - int(it_j)) <= 1
    assert int(it_t) < 200


def test_round_operands_is_round_to_nearest_even():
    """bf16 storage rounds as numpy's ml_dtypes astype does (the JAX
    package's ``astype``), and refuses other dtypes."""
    a = np.array([[1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -2.5e-3, 3e38]],
                 np.float32)
    t = torch.from_numpy(a)
    got = scg.round_operands(t, t, t, torch.bfloat16)
    want = np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
    for g in got:
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.float().numpy(), want)
    assert scg.round_operands(t, t, t, None) == (t, t, t)
    with pytest.raises(ValueError, match='operand_dtype'):
        scg.round_operands(t, t, t, torch.float16)


def test_fused_matches_dense_solve_f64():
    """float64: converged (|r| <= 1e-12 |b|) within rtol 1e-7 of numpy's
    dense solve (condition number below 1e4)."""
    edges, J, D, dcorr, Minv, b, A_dense = f64_system(53, 11)
    *ops, offsets = lane_major(edges, J, D, dcorr, Minv, b)
    x, it = scg.stencil_cg_fused(*map(torch.from_numpy, ops), offsets, 6,
                                 1000, 1e-12)
    assert x.dtype == torch.float64 and int(it) < 1000
    x_ref = np.linalg.solve(A_dense, b.reshape(-1)).reshape(53, 6)
    np.testing.assert_allclose(x.numpy().T, x_ref, rtol=1e-7, atol=1e-9)


def test_fused_f64_matches_jax_cg_body_x64():
    """float64 on both sides, 40 iterations: Chronopoulos-Gear makes the
    same iterates as standard CG in exact arithmetic, so x within rtol
    1e-9 of JAX's _cg_body under x64 (JAX's fused solver is float32
    only)."""
    *ops, offsets = lane_major(*f64_system(40, 3)[:6])
    x_t, it_t = scg.stencil_cg_fused(*map(torch.from_numpy, ops), offsets, 6,
                                     40, 0.0)
    with jax.enable_x64(True):
        b_T, A_T, Minv_T, C_T = map(jnp.asarray, ops)
        x_j, it_j = jax_cg_body(A_T, Minv_T, C_T, b_T, offsets, 6, 40, 0.0)
        x_j = np.asarray(x_j)
    assert int(it_t) == int(it_j) == 40
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize('maxiter,tol', [(250, 1e-3), (30, 0.0)])
def test_fused_matches_tiled_at_100k_shape(maxiter, tol):
    """The 100k-pose shape (offsets (1, 993), node 0 fixed): the fused and
    tiled plain versions give the same x within 1e-4 of max|x| and the
    same iteration count within one."""
    gen = torch.Generator().manual_seed(0)
    offsets, ops = random_stencil_system(100_000, 993, 80_000, True, gen)
    assert offsets == (1, 993)
    x_f, it_f = scg.stencil_cg_fused(*ops, offsets, 6, maxiter, tol)
    x_t, it_t = scg.stencil_cg_tiled(*ops, offsets, 6, maxiter, tol)
    assert abs(int(it_f) - int(it_t)) <= 1 and int(it_t) <= maxiter
    assert float((x_f - x_t).abs().max()) <= 1e-4 * float(x_t.abs().max())
    np.testing.assert_array_equal(x_f[:, 0].numpy(), 0.0)


def test_fused_edge_cases():
    N, t = 10, 6
    z = torch.zeros
    ok = (z(t, N), z(t * t, N), z(t * t, N), z(2 * t * t, N))
    x, it = scg.stencil_cg_fused(*ok, (1, 3), t, 5, 1e-5)
    assert x.shape == (t, N) and int(it) == 0  # b = 0 stops at once
    *ops, offsets = lane_major(*make_system(40, seed=1)[:6])
    x, it = scg.stencil_cg_fused(*map(torch.from_numpy, ops), offsets, t, 0,
                                 1e-5)
    assert int(it) == 0 and not x.any()
    with pytest.raises(ValueError, match='Minv_T has shape'):
        scg.stencil_cg_fused(ok[0], ok[1], z(t, N), ok[3], (1, 3), t, 5,
                             1e-5)


@pytest.mark.parametrize('bf16', [False, True])
@pytest.mark.parametrize('t', [3, 4, 7])
def test_fused_matches_jax_fused_at_block_size(t, bf16):
    """Block sizes 3, 4 and 7 at N=53, float32 and bf16 operand storage:
    the fused plain version against the JAX package's stencil_cg_fused in
    interpret mode, x within rtol 1e-4 / atol 1e-5, iterations within
    one."""
    *ops, offsets = lane_major(*make_system(53, t=t, seed=20 + t)[:6])
    x_t, it_t = scg.stencil_cg_fused(
        *map(torch.from_numpy, ops), offsets, t, 200, 1e-7,
        operand_dtype=torch.bfloat16 if bf16 else None)
    x_j, it_j = jax_stencil_cg_fused(
        *map(jnp.asarray, ops), offsets, t, 200, 1e-7, tile=16,
        interpret=True, operand_dtype=jnp.bfloat16 if bf16 else None)
    assert x_t.dtype == torch.float32 and tuple(x_t.shape) == (t, 53)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-4,
                               atol=1e-5)
    assert abs(int(it_t) - int(it_j)) <= 1
    assert int(it_t) < 200


@pytest.mark.parametrize('t', [3, 4, 7])
def test_random_stencil_system_block_size(t):
    """testing.random_stencil_system at another block size: operand
    shapes, and the three plain solvers agree on it."""
    gen = torch.Generator().manual_seed(t)
    offsets, ops = random_stencil_system(53, 9, 15, True, gen, t=t)
    assert [tuple(o.shape) for o in ops] == [
        (t, 53), (t * t, 53), (t * t, 53), (len(offsets) * t * t, 53)]
    x_w, it_w = scg.stencil_cg_transposed(*ops, offsets, t, 200, 1e-6)
    for solve in (scg.stencil_cg_fused, scg.stencil_cg_tiled):
        x, it = solve(*ops, offsets, t, 200, 1e-6)
        assert abs(int(it) - int(it_w)) <= 1 < int(it_w) < 200
        assert float((x - x_w).abs().max()) <= 1e-4 * float(x_w.abs().max())
    np.testing.assert_array_equal(x_w[:, 0].numpy(), 0.0)
