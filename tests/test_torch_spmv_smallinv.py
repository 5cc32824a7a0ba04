"""The port's small-block inverses and circulant-stencil SpMV against the
JAX package on identical numpy inputs, including StencilSpMV's
constructor refusals.

Tolerances: float64 rtol/atol 1e-12 (1e-10 for the 6x6 Schur inverse,
whose nested 3x3 inverses lose ~2 digits); float32 rtol 1e-5 / atol 1e-6
for elementwise results, and 1e-4 relative for inverses and contractions
whose sums run in another order.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pypose_tpu.ops import smallinv as jinv
from pypose_tpu.ops.spmv import StencilSpMV as JStencil
from pypose_tpu_torch.ops import smallinv as tinv
from pypose_tpu_torch.ops.spmv import StencilSpMV

DTYPES = [np.float32, np.float64]


def spd_blocks(rng, n, d):
    A = rng.normal(size=(n, d, d))
    return A @ np.swapaxes(A, -1, -2) + d * np.eye(d)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('d', [3, 4, 6])
def test_blockinv_matches_jax(d, dtype):
    M = spd_blocks(np.random.default_rng(d), 64, d).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        inv_j = np.asarray(jinv.blockinv(jnp.asarray(M)))
    inv_t = tinv.blockinv(torch.from_numpy(M)).numpy()
    tol = dict(rtol=1e-4, atol=1e-6) if dtype == np.float32 \
        else dict(rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(inv_t, inv_j, **tol)
    np.testing.assert_allclose(M @ inv_t.astype(np.float64),
                               np.broadcast_to(np.eye(d), M.shape),
                               atol=1e-4 if dtype == np.float32 else 1e-12)


def graph(rng, N, loop_offset=9, n_loops=15):
    chain = np.stack([np.arange(N - 1), np.arange(1, N)], 1)
    li = rng.integers(0, N, n_loops)
    return np.concatenate([chain, np.stack([li, (li + loop_offset) % N], 1)])


def test_stencil_refusals():
    rng = np.random.default_rng(0)
    N = 40
    # 17 distinct offsets > max_offsets=16
    many = np.stack([np.arange(17), np.arange(17) * 2 + 1], 1) % N
    with pytest.raises(ValueError, match='max_offsets'):
        StencilSpMV(many, N, 6)
    with pytest.raises(ValueError, match='max_offsets'):
        JStencil(many, N, 6)
    # 2 offsets x 40 nodes for 5 edges: channels mostly zeros
    sparse = np.array([[0, 1], [1, 2], [5, 9], [7, 11], [20, 24]])
    with pytest.raises(ValueError, match='too sparse'):
        StencilSpMV(sparse, N, 6)
    with pytest.raises(ValueError, match='too sparse'):
        JStencil(sparse, N, 6)
    edges = graph(rng, N)
    assert StencilSpMV(edges, N, 6).offsets == JStencil(edges, N, 6).offsets


@pytest.mark.parametrize('dtype', DTYPES)
def test_stencil_precompute_couple_matvec(dtype):
    """precompute_multi over two factors (merged channels, duplicate
    slots summed), couple and matvec."""
    rng = np.random.default_rng(1)
    N, t = 53, 6
    edges = graph(rng, N)
    # a duplicated (node, offset) slot, which must sum
    edges = np.concatenate([edges, edges[3:4]])
    E = edges.shape[0]
    J = rng.normal(size=(E, 6, 2, t)).astype(dtype)
    WJ = (J * rng.uniform(0.5, 2.0, size=(E, 6, 1, 1))).astype(dtype)
    D = spd_blocks(rng, N, t).astype(dtype)
    x = rng.normal(size=(N, t)).astype(dtype)
    split = 20
    with jax.enable_x64(dtype == np.float64):
        js = JStencil(edges, N, t)
        pairs = [(jnp.asarray(J[:split]), jnp.asarray(WJ[:split])),
                 (jnp.asarray(J[split:]), jnp.asarray(WJ[split:]))]
        C_j = js.precompute_multi(pairs)
        y_j = np.asarray(js.couple(C_j, jnp.asarray(x)))
        mv_j = np.asarray(js.matvec(C_j, jnp.asarray(D), jnp.asarray(x)))
        C_j = np.asarray(C_j)
    ts = StencilSpMV(torch.from_numpy(edges), N, t)
    C_t = ts.precompute_multi(
        [(torch.from_numpy(J[:split]), torch.from_numpy(WJ[:split])),
         (torch.from_numpy(J[split:]), torch.from_numpy(WJ[split:]))])
    assert C_t.shape == (len(ts.offsets), N, t, t)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == np.float32 \
        else dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(C_t.numpy(), C_j, **tol)
    y_t = ts.couple(C_t, torch.from_numpy(x)).numpy()
    mv_t = ts.matvec(C_t, torch.from_numpy(D), torch.from_numpy(x)).numpy()
    # the JAX couple accumulates in float32 whatever the channel dtype
    # (pypose_tpu/ops/spmv.py:273-283), so it is float32-accurate only
    np.testing.assert_allclose(y_t, y_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mv_t, mv_j, rtol=1e-4, atol=1e-5)
    # ... and the port keeps the dtype: exact against a numpy stencil
    Cn = C_t.numpy().astype(np.float64)
    y_ref = np.zeros((N, t))
    for k, d in enumerate(ts.offsets):
        src = (np.arange(N) + d) % N
        y_ref += np.einsum('ntu,nu->nt', Cn[k], x[src])
        np.add.at(y_ref, src, np.einsum('ntu,nt->nu', Cn[k], x))
    np.testing.assert_allclose(y_t, y_ref, **tol)
    np.testing.assert_allclose(mv_t, y_ref + np.einsum('ntu,nu->nt', D, x),
                               **tol)
    # single-factor precompute is the same merged channel build
    np.testing.assert_allclose(
        ts.precompute(torch.from_numpy(J), torch.from_numpy(WJ)).numpy(),
        C_t.numpy(), **tol)
