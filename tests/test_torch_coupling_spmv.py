"""The port's CouplingSpMV against the JAX package's on identical numpy
inputs, and against a dense J^T W J: a contiguous chain with loops, a
chain that is not contiguous (the dir_ci / dir_cj path), loops only, at
t = 3 and 6, in float32 and float64.

Tolerances: float64 rtol/atol 1e-12; float32 rtol 1e-4 / atol 1e-5 (the
coupling blocks and their products sum in another order: the JAX package
builds C_e column by column, spmv.py:35-49, the port by one einsum).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pypose_tpu.ops.spmv import CouplingSpMV as JCoupling
from pypose_tpu_torch.ops.spmv import TILE, CouplingSpMV


def tol(dtype):
    return dict(rtol=1e-4, atol=1e-5) if dtype == np.float32 \
        else dict(rtol=1e-12, atol=1e-12)


def make_edges(kind, N, rng):
    """[E, 2] edges: 'chain' (i -> i+1 over 0..N-2, then loops),
    'broken' (chain runs with gaps, then loops: not contiguous) or
    'loops' (random pairs only)."""
    li = rng.integers(0, N, 3 * N // 4)
    lj = (li + rng.integers(2, N - 1, li.shape)) % N
    loops = np.stack([li, lj], 1)
    ii = np.arange(N - 1)
    chain = np.stack([ii, ii + 1], 1)
    if kind == 'chain':
        return np.concatenate([chain, loops])
    if kind == 'broken':
        return np.concatenate([np.delete(chain, [5, N // 2], axis=0), loops])
    return loops


def dense_coupling(edges, C, N, t):
    """sum_e C_e at block (i, j) and C_e^T at (j, i), float64."""
    A = np.zeros((N * t, N * t))
    for (i, j), c in zip(edges, C.astype(np.float64)):
        A[i * t:(i + 1) * t, j * t:(j + 1) * t] += c
        A[j * t:(j + 1) * t, i * t:(i + 1) * t] += c.T
    return A


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('t', [3, 6])
@pytest.mark.parametrize('kind', ['chain', 'broken', 'loops'])
def test_coupling_spmv_matches_jax_and_dense(kind, t, dtype):
    rng = np.random.default_rng(['chain', 'broken', 'loops'].index(kind)
                                * 10 + t)
    N = 300                      # three tiles, the last one partial
    edges = make_edges(kind, N, rng)
    E, d = edges.shape[0], 6
    J = rng.normal(size=(E, d, 2, t)).astype(dtype)
    WJ = (J * rng.uniform(0.5, 2.0, size=(E, d, 1, 1))).astype(dtype)
    D = rng.normal(size=(N, t, t)).astype(dtype)
    x = rng.normal(size=(N, t)).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        js = JCoupling(edges, N, t)
        st = js.precompute(jnp.asarray(J), jnp.asarray(WJ))
        y_j = np.asarray(js.couple(st, jnp.asarray(x)))
        mv_j = np.asarray(js.matvec(st, jnp.asarray(D), jnp.asarray(x)))
    ts = CouplingSpMV(torch.from_numpy(edges), N, t,
                      dtype=torch.from_numpy(x).dtype)
    assert ts.T == js.T == -(-N // TILE)
    assert ts._chain_contig == js._chain_contig == (kind == 'chain')
    assert sorted(ts.dirs) == sorted(
        n for n in ('i', 'j', 'ci', 'cj')
        if getattr(js, 'dir_' + n, None) is not None)
    for name, dirn in ts.dirs.items():
        assert dirn['K'] == getattr(js, 'dir_' + name)['K']
    state = ts.precompute(torch.from_numpy(J), torch.from_numpy(WJ))
    y_t = ts.couple(state, torch.from_numpy(x)).numpy()
    mv_t = ts.matvec(state, torch.from_numpy(D), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y_t, y_j, **tol(dtype))
    np.testing.assert_allclose(mv_t, mv_j, **tol(dtype))
    C = np.einsum('edt,edu->etu', WJ[:, :, 0].astype(np.float64),
                  J[:, :, 1].astype(np.float64))
    y_ref = (dense_coupling(edges, C, N, t) @ x.reshape(-1).astype(
        np.float64)).reshape(N, t)
    np.testing.assert_allclose(y_t, y_ref, **tol(dtype))


def test_coupling_spmv_one_hot_order_is_fixed():
    """Two loop edges into one node: the one-hot product sums them in the
    order the constructor sorted them, so repeated calls give the same
    bits (no atomics)."""
    rng = np.random.default_rng(0)
    N, t = 200, 6
    edges = np.array([[3, 150], [7, 150], [150, 9], [199, 0]])
    J = torch.from_numpy(rng.normal(size=(4, 6, 2, t)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(N, t)).astype(np.float32))
    sp = CouplingSpMV(edges, N, t)
    assert sp.chain_rows.size == 0 and list(sp.loop_rows) == [0, 1, 2, 3]
    state = sp.precompute(J, J)
    y1, y2 = sp.couple(state, x), sp.couple(state, x)
    assert torch.equal(y1, y2)
    touched = {0, 3, 7, 9, 150, 199}
    untouched = [n for n in range(N) if n not in touched]
    assert torch.all(y1[untouched] == 0)
