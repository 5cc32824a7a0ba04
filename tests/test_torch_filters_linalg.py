"""The point-cloud filters and function/linalg.py of the port against the
JAX package on the same numpy clouds: nbr_filter, voxel_filter (means),
knn_filter (with and without radius and pdim), bvv/bmv/bvmv; and the
random filters, whose draws come from a torch.Generator where the JAX
package draws from a jax.random key (so they are held to what they must
be: a subset of the input, one point a voxel, the same draw from equal
generators), in float32 and float64.

Tolerances: masks and shapes equal; values 1e-6 (float32) and 1e-12
(float64).  knn_filter sums the same k + 1 neighbours (the clouds have no
distance ties) in another order.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu as jpp
import pypose_tpu_torch as pp
from pypose_tpu_torch.testing import cap_threads

cap_threads()

DTYPES = ['float32', 'float64']
TOL = {'float32': 1e-6, 'float64': 1e-12}


def cloud(n, dtype, seed=0, d=3):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, d)) * 0.3
    pts[-1] = 100.0                     # an outlier no filter keeps
    return pts.astype(dtype)


def jarr(x, dtype):
    with jax.enable_x64(dtype == 'float64'):
        return np.asarray(x())


@pytest.mark.parametrize('dtype', DTYPES)
def test_nbr_filter_matches_jax(dtype):
    pts = cloud(200, dtype)
    with jax.enable_x64(dtype == 'float64'):
        jout, jmask = jpp.nbr_filter(jnp.asarray(pts), nbr=3, radius=0.2,
                                     return_mask=True)
        jout2 = jpp.nbr_filter(jnp.asarray(pts), nbr=2, radius=0.15, pdim=2,
                               ord=1)
        jout, jmask, jout2 = map(np.asarray, (jout, jmask, jout2))
    tout, tmask = pp.nbr_filter(torch.from_numpy(pts), nbr=3, radius=0.2,
                                return_mask=True)
    tout2 = pp.nbr_filter(torch.from_numpy(pts), nbr=2, radius=0.15, pdim=2,
                          ord=1)
    np.testing.assert_array_equal(tmask.numpy(), jmask)
    np.testing.assert_array_equal(tout.numpy(), jout)
    np.testing.assert_array_equal(tout2.numpy(), jout2)
    assert 0 < tout.shape[0] < pts.shape[0] and not (tout.numpy() > 50).any()


@pytest.mark.parametrize('dtype', DTYPES)
def test_voxel_filter_matches_jax(dtype):
    pts = cloud(300, dtype, seed=1)
    for voxel in ([0.2, 0.2, 0.2], [0.3, 0.5]):
        want = jarr(lambda: jpp.voxel_filter(jnp.asarray(pts), voxel), dtype)
        got = pp.voxel_filter(torch.from_numpy(pts), voxel)
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL[dtype],
                                   atol=TOL[dtype])
    small = torch.tensor([[0.1, 0.1], [0.2, 0.2], [1.1, 1.1]])
    out = pp.voxel_filter(small, [1., 1.]).numpy()
    np.testing.assert_allclose(out[np.lexsort(out.T)],
                               [[0.15, 0.15], [1.1, 1.1]], atol=1e-6)


def test_voxel_filter_random_picks_one_point_a_voxel():
    pts = cloud(300, 'float32', seed=2)
    voxel = [0.25, 0.25, 0.25]
    t = torch.from_numpy(pts)
    out = pp.voxel_filter(t, voxel, random=True,
                          generator=torch.Generator().manual_seed(3))
    again = pp.voxel_filter(t, voxel, random=True,
                            generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(out.numpy(), again.numpy())
    means = pp.voxel_filter(t, voxel)
    assert out.shape == means.shape
    rows = {tuple(r) for r in pts}
    assert all(tuple(r) in rows for r in out.numpy())
    key = ((out.numpy() - pts.min(0)) // voxel).astype(np.int64)
    assert len({tuple(k) for k in key}) == out.shape[0]


def test_random_filter_subset_and_generator():
    pts = torch.from_numpy(cloud(500, 'float32', seed=4))
    a = pp.random_filter(pts, 40, torch.Generator().manual_seed(5))
    b = pp.random_filter(pts, 40, torch.Generator().manual_seed(5))
    c = pp.random_filter(pts, 40, torch.Generator().manual_seed(6))
    assert a.shape == (40, 3) and torch.equal(a, b) and not torch.equal(a, c)
    rows = {tuple(r) for r in pts.numpy()}
    assert all(tuple(r) in rows for r in a.numpy())
    assert len({tuple(r) for r in a.numpy()}) == 40
    batched = pp.random_filter(pts.expand(2, 500, 3), 7,
                               torch.Generator().manual_seed(5))
    assert batched.shape == (2, 7, 3)
    with pytest.raises(AssertionError):
        pp.random_filter(pts, 501)
    # the JAX package's filter, for the same contract
    sub = jpp.random_filter(jnp.asarray(pts.numpy()), 40,
                            key=jax.random.PRNGKey(9))
    assert sub.shape == (40, 3)


@pytest.mark.parametrize('dtype', DTYPES)
def test_knn_filter_matches_jax(dtype):
    pts = cloud(120, dtype, seed=7)
    cases = [dict(k=3), dict(k=5, pdim=2), dict(k=4, radius=0.3),
             dict(k=2, ord=1)]
    for kw in cases:
        want = jarr(lambda: jpp.knn_filter(jnp.asarray(pts), **kw), dtype)
        got = pp.knn_filter(torch.from_numpy(pts), **kw).numpy()
        assert got.shape == want.shape, kw
        np.testing.assert_allclose(got, want, rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=str(kw))


@pytest.mark.parametrize('dtype', DTYPES)
def test_bvv_bmv_bvmv_match_jax(dtype):
    rng = np.random.default_rng(8)
    a = rng.normal(size=(2, 5, 3)).astype(dtype)
    b = rng.normal(size=(2, 5, 4)).astype(dtype)
    M = rng.normal(size=(2, 5, 3, 4)).astype(dtype)
    with jax.enable_x64(dtype == 'float64'):
        ja, jb, jM = map(jnp.asarray, (a, b, M))
        want = [np.asarray(f) for f in (
            jpp.bvv(ja, jb), jpp.bmv(jM, jb), jpp.bvmv(ja, jM, jb),
            jpp.bvmv(ja[0, 0], jM[0, 0], jb[0, 0]))]
    ta, tb, tM = map(torch.from_numpy, (a, b, M))
    got = [pp.bvv(ta, tb), pp.bmv(tM, tb), pp.bvmv(ta, tM, tb),
           pp.bvmv(ta[0, 0], tM[0, 0], tb[0, 0])]
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL[dtype] * 10,
                                   atol=TOL[dtype] * 10)
    assert tuple(got[3].shape) == (1,)
    # LieTensor inputs read their storage
    q = pp.randn_SO3(2, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(pp.bvv(q, q).numpy(),
                               pp.bvv(q.tensor(), q.tensor()).numpy())
    with pytest.raises(AssertionError):
        pp.bmv(tM, ta)
