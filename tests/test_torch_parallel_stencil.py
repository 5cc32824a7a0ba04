"""The port's sharded_stencil_matvec on 4 gloo CPU ranks (spawned once for
the module) against ``StencilSpMV.matvec`` and against the JAX package's
shard_map version on its 8-device virtual mesh, on identical numpy
inputs: the ring stencil of tests/parallel/test_collectives.py (N = 256,
offsets 1 and 17, t = 6).

Tolerance: within 1e-6 of max|y| (float32; the blocks sum the same
products in another association).  The schedule: two messages per offset
(a halo and a transposed tail of r rows each, every offset being below
the block size S = 64), through ``batch_isend_irecv`` only, and no other
collective; at one rank, none.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu.parallel as jpar
from pypose_tpu.ops.spmv import StencilSpMV as JStencil
from pypose_tpu_torch.ops.spmv import StencilSpMV
from pypose_tpu_torch.testing import cap_threads
from pypose_tpu_torch.testing.dist import run_ranks

cap_threads()

N, STRIDE, T = 256, 17, 6


def ring_system(seed=0):
    """The edges, and random C [n_off, N, t, t], D [N, t, t], x [N, t]."""
    ii = np.arange(N)
    edges = np.concatenate([np.stack([ii, (ii + 1) % N], 1),
                            np.stack([ii[::3], (ii[::3] + STRIDE) % N], 1)])
    rng = np.random.default_rng(seed)
    n_off = len(np.unique((edges[:, 1] - edges[:, 0]) % N))
    C = (0.1 * rng.normal(size=(n_off, N, T, T))).astype(np.float32)
    D = (np.eye(T) + 0.1 * rng.normal(size=(N, T, T))).astype(np.float32)
    x = rng.normal(size=(N, T)).astype(np.float32)
    return edges, C, D, x


EDGES, C, D, X = ring_system()


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    return run_ranks(4, [('mv', 'stencil', dict(edges=EDGES, N=N, tan=T, C=C,
                                                D=D, x=X))],
                     tmp_path_factory.mktemp('stencil'))


def reference():
    st = StencilSpMV(torch.as_tensor(EDGES), N, T)
    return st, st.matvec(torch.as_tensor(C), torch.as_tensor(D),
                         torch.as_tensor(X)).numpy()


def test_children_never_import_jax(ranks):
    assert not any(r['jax_imported'] for r in ranks)


def test_matches_stencil_matvec(ranks):
    st, want = reference()
    got = np.concatenate([r['mv']['y'] for r in ranks])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_matches_jax_shard_map(ranks):
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 virtual devices')
    jst = JStencil(EDGES, N, T)
    fn = jax.jit(jpar.sharded_stencil_matvec(jst, jpar.make_mesh(8, 'mp'),
                                             axis='mp'))
    want = np.asarray(fn(jnp.asarray(C), jnp.asarray(D), jnp.asarray(X)))
    got = np.concatenate([r['mv']['y'] for r in ranks])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_halo_exchange_schedule(ranks):
    for r in ranks:
        assert r['mv']['offsets'] == [1, STRIDE]
        assert r['mv']['messages'] == 2 * len(r['mv']['offsets'])
        assert r['mv']['collectives'] == {}


def test_one_rank_exchanges_nothing():
    import torch.distributed as dist
    from pypose_tpu_torch.parallel import make_mesh, stencil
    assert not dist.is_initialized()
    try:
        mesh = make_mesh(axis='mp', device_type='cpu')
        st, want = reference()
        before = stencil.MESSAGES
        got = stencil.sharded_stencil_matvec(st, mesh, axis='mp')(
            torch.as_tensor(C), torch.as_tensor(D), torch.as_tensor(X))
        assert stencil.MESSAGES == before
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    finally:
        dist.destroy_process_group()
