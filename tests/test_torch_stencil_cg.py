"""The port's whole-solve stencil CG: its plain version on the CPU against
the JAX package's stencil_cg(use_pallas=False) and a dense numpy solve,
with and without fixed nodes; the wrapper's checks; and the build's
refusal without nvcc.  The CUDA kernel's own tests are in
test_torch_cuda.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pypose_tpu.ops.pallas_cg import stencil_cg as jax_stencil_cg
from pypose_tpu.ops.spmv import StencilSpMV as JStencil
from pypose_tpu_torch.ops import _build
from pypose_tpu_torch.ops import stencil_cg as scg
from pypose_tpu_torch.ops.smallinv import blockinv
from pypose_tpu_torch.ops.spmv import StencilSpMV


def make_system(N, t=6, seed=0):
    """SPD stencil system from a chain + loop pose graph, as
    tests/ops/test_pallas_cg.py:make_system builds it, in numpy."""
    rng = np.random.default_rng(seed)
    chain = np.stack([np.arange(N - 1), np.arange(1, N)], 1)
    li = rng.integers(0, N, 15)
    edges = np.concatenate([chain, np.stack([li, (li + 9) % N], 1)], 0)
    E = edges.shape[0]
    J = rng.normal(size=(E, 6, 2, t)).astype(np.float32)
    D = np.zeros((N, t, t), np.float32)
    A_dense = np.zeros((N * t, N * t))
    for e in range(E):
        i, j = edges[e]
        D[i] += J[e, :, 0, :].T @ J[e, :, 0, :]
        D[j] += J[e, :, 1, :].T @ J[e, :, 1, :]
        Jf = np.zeros((6, N * t))
        Jf[:, i * t:(i + 1) * t] = J[e, :, 0, :]
        Jf[:, j * t:(j + 1) * t] = J[e, :, 1, :]
        A_dense += Jf.T @ Jf
    dcorr = (0.1 * np.clip(np.einsum('ntt->nt', D), 1e-6, 1e32)) \
        .astype(np.float32)
    A_dense += np.diag(dcorr.reshape(-1))
    Minv = blockinv(torch.from_numpy(
        D + dcorr[..., None] * np.eye(t, dtype=np.float32))).numpy()
    b = rng.normal(size=(N, t)).astype(np.float32)
    return edges, J, D, dcorr, Minv, b, A_dense


@pytest.mark.parametrize('fixed', [False, True])
@pytest.mark.parametrize('N', [40, 53])
def test_stencil_cg_matches_jax_and_dense(N, fixed):
    """x within rtol 1e-4 of JAX (float32 CG, sums in another order) and
    iteration counts within one; both within the JAX test's 5e-3 of the
    dense solve."""
    edges, J, D, dcorr, Minv, b, A_dense = make_system(N, seed=N)
    t = b.shape[1]
    mask = np.zeros(N, bool)
    mask[0] = fixed
    js = JStencil(edges, N, t)
    C_j = js.precompute(jnp.asarray(J), jnp.asarray(J))
    x_j, it_j = jax_stencil_cg(
        jnp.asarray(b), jnp.asarray(D), jnp.asarray(dcorr),
        jnp.asarray(Minv), C_j, tuple(js.offsets),
        fixed_mask=jnp.asarray(mask) if fixed else None,
        maxiter=400, tol=1e-7, use_pallas=False)
    ts = StencilSpMV(edges, N, t)
    C_t = ts.precompute(torch.from_numpy(J), torch.from_numpy(J))
    x_t, it_t = scg.stencil_cg(
        torch.from_numpy(b), torch.from_numpy(D), torch.from_numpy(dcorr),
        torch.from_numpy(Minv), C_t, tuple(ts.offsets),
        fixed_mask=torch.from_numpy(mask) if fixed else None,
        maxiter=400, tol=1e-7)
    x_t = x_t.numpy()
    np.testing.assert_allclose(x_t, np.asarray(x_j), rtol=1e-4, atol=1e-5)
    assert abs(int(it_t) - int(it_j)) <= 1
    assert int(it_t) < 400
    keep = np.ones(N * t, bool)
    if fixed:
        np.testing.assert_array_equal(x_t[0], 0.0)
        keep[:t] = False
    x_ref = np.linalg.solve(A_dense[np.ix_(keep, keep)],
                            b.reshape(-1)[keep])
    np.testing.assert_allclose(x_t.reshape(-1)[keep], x_ref, rtol=5e-3,
                               atol=5e-4)


def test_transposed_wrapper_checks_shapes():
    N, t = 10, 6
    z = torch.zeros
    ok = (z(t, N), z(t * t, N), z(t * t, N), z(2 * t * t, N))
    x, it = scg.stencil_cg_transposed(*ok, (1, 3), t, 5, 1e-5)
    assert x.shape == (t, N) and int(it) == 0  # b = 0 stops at once
    with pytest.raises(ValueError, match='C_T has shape'):
        scg.stencil_cg_transposed(*ok[:3], z(t * t, N), (1, 3), t, 5, 1e-5)
    with pytest.raises(ValueError, match='A_T has shape'):
        scg.stencil_cg_transposed(ok[0], z(t, N), *ok[2:], (1, 3), t, 5,
                                  1e-5)


def test_fits_budget():
    # sphere2500: ~1.8 MB of operands and state
    assert scg.stencil_cg_fits(2500, 6, 2)
    # 100k poses with 2 offsets: ~72 MB, past the L2 budget
    assert not scg.stencil_cg_fits(100_000, 6, 2)


@pytest.mark.parametrize('N,l2_bytes,state_bytes,smem_bytes,fits,smem', [
    # sphere2500: NL = 157; operands in shared memory
    (2500, 1_680_000, 15_584, 124_856, True, True),
    # NL = 1250: operands in L2, the state alone in shared memory
    (20_000, 13_440_000, 120_512, 990_512, True, False),
    # past the L2 budget: the tiled route
    (100_000, 67_200_000, 600_512, 4_950_512, False, False)])
def test_budget_predicates(N, l2_bytes, state_bytes, smem_bytes, fits, smem):
    """The predicates against the byte sums of their docstrings (t = 6,
    2 offsets, a cluster of 16): L2 4 N (t + 2tt + 2tt + t + 2t) <= 25e6;
    per CTA 4 (128 + NL (2t + 2t)) and 4 (128 + NL (5t + 4t + 2tt + 2tt))
    against 232,448."""
    t, n_off, NL = 6, 2, -(-N // 16)
    assert 4 * N * (t + 2 * t * t + n_off * t * t + 3 * t) == l2_bytes
    assert 4 * (128 + NL * (2 * t + n_off * t)) == state_bytes
    assert 4 * (128 + NL * (9 * t + 4 * t * t)) == smem_bytes
    assert scg.stencil_cg_fits(N, t, n_off) == fits == (
        l2_bytes <= 25e6 and state_bytes <= 232_448)
    assert scg.stencil_cg_smem_fits(N, t, n_off) == smem == (
        smem_bytes <= 232_448)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build.nvcc_path()
