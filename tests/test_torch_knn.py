"""The port's nearest neighbours against the JAX package on identical numpy
inputs: the plain versions of ``ops/knn.py:nn1``/``nnk`` against the
Pallas kernels in interpret mode, and ``function/geometry.py:knn`` (dense)
and ``_knn_tiled`` (chunked) against their JAX counterparts.

Tolerances: squared distances in the Gram form agree within
1e-6 (|a|^2 + |b|^2) + 1e-6 (a few float32 ulps of the terms that cancel);
indices agree exactly where the two nearest candidates' float64 distances
differ by more than that, and everywhere on exact ties (duplicated or
integer points), where both packages take the lower index.  Dense
distances (no cancellation) agree within rtol 1e-6, atol 1e-6.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pypose_tpu.function import geometry as jgeo
from pypose_tpu.ops import pallas_knn
from pypose_tpu_torch.function import geometry as tgeo
from pypose_tpu_torch.ops import knn as tknn


def clouds(seed, R, N, D=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(R, D)).astype(np.float32),
            rng.normal(size=(N, D)).astype(np.float32))


def true_d2(ref, nbr):
    ref, nbr = ref.astype(np.float64), nbr.astype(np.float64)
    return ((ref[:, None] - nbr[None]) ** 2).sum(-1)


def bound(ref, nbr, idx):
    """1e-6 (|a|^2 + |b|^2) + 1e-6 for each row's chosen neighbours."""
    an = (ref.astype(np.float64) ** 2).sum(-1)[:, None]
    bn = (nbr.astype(np.float64) ** 2).sum(-1)[idx]
    return 1e-6 * (an + bn) + 1e-6


def assert_knn_agree(ref, nbr, d2_t, idx_t, d2_j, idx_j, largest=False):
    """[R, k] results of the port and of JAX for the same clouds."""
    d2_t, idx_t = np.asarray(d2_t), np.asarray(idx_t)
    d2_j, idx_j = np.asarray(d2_j), np.asarray(idx_j)
    assert d2_t.shape == d2_j.shape and idx_t.shape == idx_j.shape
    assert d2_t.dtype == np.float32 and idx_t.dtype == np.int64
    assert (np.abs(d2_t - d2_j) <= bound(ref, nbr, idx_j)).all()
    k = d2_t.shape[1]
    exact = np.sort(true_d2(ref, nbr), axis=1)
    exact = exact[:, ::-1] if largest else exact
    gap = np.abs(np.diff(exact[:, :k + 1], axis=1)) > bound(ref, nbr, idx_j)
    # rank s is unambiguous when it is clear of ranks s - 1 and s + 1
    clear = np.concatenate([gap[:, :1], gap[:, :-1] & gap[:, 1:]], 1)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(idx_t[clear], idx_j[clear])


@pytest.mark.parametrize('R,N', [(333, 777), (64, 128), (1, 5), (130, 3000)])
def test_nn1_matches_pallas(R, N):
    """Shapes that are and are not multiples of the 64 x 128 tiles."""
    ref, nbr = clouds(R + N, R, N)
    d2_t, idx_t = tknn.nn1(torch.from_numpy(ref), torch.from_numpy(nbr))
    d2_j, idx_j = pallas_knn.nn1(jnp.asarray(ref), jnp.asarray(nbr), tr=64,
                                 tn=128, interpret=True)
    assert d2_t.shape == (R,) and idx_t.shape == (R,)
    assert_knn_agree(ref, nbr, d2_t[:, None], idx_t[:, None],
                     np.asarray(d2_j)[:, None], np.asarray(idx_j)[:, None])
    assert (d2_t >= 0).all()


@pytest.mark.parametrize('tn', [16, 128])
@pytest.mark.parametrize('k', [2, 4, 7, 16])
def test_nnk_matches_pallas(k, tn):
    """k at and above the neighbour tile size (tn=16), and a padded last
    tile (333 = 2 x 128 + 77)."""
    ref, nbr = clouds(7, 150, 333)
    d2_t, idx_t = tknn.nnk(torch.from_numpy(ref), torch.from_numpy(nbr), k)
    d2_j, idx_j = pallas_knn.nnk(jnp.asarray(ref), jnp.asarray(nbr), k,
                                 tr=64, tn=tn, interpret=True)
    assert_knn_agree(ref, nbr, d2_t, idx_t, d2_j, idx_j)
    assert (np.diff(d2_t.numpy(), axis=1) >= 0).all()


@pytest.mark.parametrize('k', [1, 2, 3])
def test_ties_take_the_lower_index(k):
    """Duplicated neighbours give equal distances: the port and the Pallas
    kernels keep the lower index first."""
    rng = np.random.default_rng(3)
    base = rng.normal(size=(200, 3)).astype(np.float32)
    dup = rng.permutation(200)[:80]
    nbr = np.concatenate([base, base[dup]])
    ref = base[dup[:50]] + np.float32(1e-3)
    d2_t, idx_t = tknn.nnk(torch.from_numpy(ref), torch.from_numpy(nbr), k)
    d2_j, idx_j = pallas_knn.nnk(jnp.asarray(ref), jnp.asarray(nbr), k,
                                 tr=64, tn=128, interpret=True)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(idx_t[:, 0].numpy(), dup[:50])
    if k > 1:
        np.testing.assert_array_equal(idx_t[:, 1].numpy(), 200 + np.arange(50))
        np.testing.assert_array_equal(d2_t[:, 0].numpy(), d2_t[:, 1].numpy())


def test_k_above_n_raises():
    ref, nbr = clouds(1, 10, 5)
    with pytest.raises(ValueError, match='k=6'):
        pallas_knn.nnk(jnp.asarray(ref), jnp.asarray(nbr), 6, interpret=True)
    with pytest.raises(ValueError, match='k=6'):
        tknn.nnk(torch.from_numpy(ref), torch.from_numpy(nbr), 6)
    with pytest.raises(ValueError, match='must be'):
        tknn.nn1(torch.zeros(4, 3), torch.zeros(5, 2))


@pytest.mark.parametrize('largest', [False, True])
@pytest.mark.parametrize('ord', [1, 2])
def test_dense_knn_matches_jax(ord, largest):
    """Unbatched and batched clouds; distances within rtol/atol 1e-6,
    indices exact where the float64 distances are clearly apart."""
    for shape_r, shape_n in (((50, 3), (60, 3)), ((2, 40, 3), (2, 70, 3))):
        rng = np.random.default_rng(len(shape_r) + ord)
        ref = rng.normal(size=shape_r).astype(np.float32)
        nbr = rng.normal(size=shape_n).astype(np.float32)
        res_t = tgeo.knn(torch.from_numpy(ref), torch.from_numpy(nbr), k=4,
                         ord=ord, largest=largest)
        res_j = jgeo.knn(jnp.asarray(ref), jnp.asarray(nbr), k=4, ord=ord,
                         largest=largest)
        v_t, v_j = res_t.values.numpy(), np.asarray(res_j.values)
        np.testing.assert_allclose(v_t, v_j, rtol=1e-6, atol=1e-6)
        diff = ref[..., :, None, :].astype(np.float64) \
            - nbr[..., None, :, :]
        dist = np.linalg.norm(diff, ord=ord, axis=-1)
        dist = -np.sort(-dist, -1) if largest else np.sort(dist, -1)
        gap = np.abs(np.diff(dist[..., :5], axis=-1)) > 1e-5
        clear = np.concatenate([gap[..., :1], gap[..., :-1] & gap[..., 1:]],
                               -1)
        np.testing.assert_array_equal(res_t.indices.numpy()[clear],
                                      np.asarray(res_j.indices)[clear])


@pytest.mark.parametrize('largest', [False, True])
@pytest.mark.parametrize('ord', [1, 2])
def test_dense_knn_exact_ties(ord, largest):
    """Integer points: many distances are exactly equal in both packages,
    and both order them by index (jax.lax.top_k; the port's stable sort)."""
    rng = np.random.default_rng(11)
    ref = rng.integers(0, 3, size=(30, 3)).astype(np.float32)
    nbr = rng.integers(0, 3, size=(40, 3)).astype(np.float32)
    res_t = tgeo.knn(torch.from_numpy(ref), torch.from_numpy(nbr), k=10,
                     ord=ord, largest=largest)
    res_j = jgeo.knn(jnp.asarray(ref), jnp.asarray(nbr), k=10, ord=ord,
                     largest=largest)
    np.testing.assert_array_equal(res_t.values.numpy(),
                                  np.asarray(res_j.values))
    np.testing.assert_array_equal(res_t.indices.numpy(),
                                  np.asarray(res_j.indices))


@pytest.mark.parametrize('largest', [False, True])
@pytest.mark.parametrize('k', [1, 8])
def test_knn_tiled_matches_jax(k, largest):
    """The chunked Gram path with an explicit chunk (100 rows in chunks of
    64), through ``knn`` and ``_knn_tiled``; on the CPU neither package
    calls its nn1 kernel."""
    ref, nbr = clouds(5, 100, 200)
    rt, nt = torch.from_numpy(ref), torch.from_numpy(nbr)
    res_j = jgeo._knn_tiled(jnp.asarray(ref), jnp.asarray(nbr), k, largest,
                            64)
    for res_t in (tgeo._knn_tiled(rt, nt, k, largest, 64),
                  tgeo.knn(rt, nt, k=k, largest=largest, chunk=64)):
        assert res_t.values.shape == (100, k)
        assert_knn_agree(ref, nbr, res_t.values.numpy() ** 2, res_t.indices,
                         np.asarray(res_j.values) ** 2, res_j.indices,
                         largest)


def test_knn_tiled_cpu_does_not_launch(monkeypatch):
    """k = 1 on the CPU takes the chunked path (as JAX off the TPU): the
    nn1 wrapper is not called."""
    def boom(*args):
        raise AssertionError('nn1 called on the CPU route')
    monkeypatch.setattr(tknn, 'nn1', boom)
    ref, nbr = clouds(2, 50, 80)
    res = tgeo._knn_tiled(torch.from_numpy(ref), torch.from_numpy(nbr), 1,
                          False, 16)
    assert res.indices.shape == (50, 1)


def test_knn_tiled_cpu_k8_does_not_launch(monkeypatch):
    """k = 8 on the CPU takes the chunked Gram path, as the JAX package
    does off the TPU: the nnk wrapper is not called (on CUDA it is)."""
    def boom(*args):
        raise AssertionError('nnk called on the CPU route')
    monkeypatch.setattr(tknn, 'nnk', boom)
    ref, nbr = clouds(2, 50, 80)
    rt, nt = torch.from_numpy(ref), torch.from_numpy(nbr)
    res = tgeo._knn_tiled(rt, nt, 8, False, 16)
    gram = tgeo._knn_gram(rt, nt, 8, False, 16)
    assert res.indices.shape == (50, 8)
    assert torch.equal(res.indices, gram.indices)
    assert torch.equal(res.values, gram.values)


@pytest.mark.parametrize('D', [5, 6, 7, 8])
def test_nn1_matches_pallas_wide_points(D):
    """Points of 5 to 8 coordinates (a point with its normal is D = 6),
    which the CUDA kernels take since the D <= 8 instantiations."""
    ref, nbr = clouds(D, 150, 333, D)
    d2_t, idx_t = tknn.nn1(torch.from_numpy(ref), torch.from_numpy(nbr))
    d2_j, idx_j = pallas_knn.nn1(jnp.asarray(ref), jnp.asarray(nbr), tr=64,
                                 tn=128, interpret=True)
    assert_knn_agree(ref, nbr, d2_t[:, None], idx_t[:, None],
                     np.asarray(d2_j)[:, None], np.asarray(idx_j)[:, None])


@pytest.mark.parametrize('D', [5, 6, 7, 8])
@pytest.mark.parametrize('k', [2, 8])
def test_nnk_matches_pallas_wide_points(k, D):
    ref, nbr = clouds(10 * D + k, 150, 333, D)
    d2_t, idx_t = tknn.nnk(torch.from_numpy(ref), torch.from_numpy(nbr), k)
    d2_j, idx_j = pallas_knn.nnk(jnp.asarray(ref), jnp.asarray(nbr), k,
                                 tr=64, tn=128, interpret=True)
    assert_knn_agree(ref, nbr, d2_t, idx_t, d2_j, idx_j)


@pytest.mark.parametrize('k', [1, 8])
def test_plain_versions_float64_match_jax(k):
    """The plain versions of nn1 and nnk in float64, which the card's
    float64 instantiations are held to, against the JAX package's Gram
    path under x64 at D = 6: d2 within rtol 1e-12 (atol 1e-12), indices
    equal."""
    import jax
    ref, nbr = (a.astype(np.float64) for a in clouds(60 + k, 100, 300, 6))
    with jax.enable_x64(True):
        res_j = jgeo._knn_tiled(jnp.asarray(ref), jnp.asarray(nbr), k, False,
                                64)
        d2_j, i_j = np.asarray(res_j.values) ** 2, np.asarray(res_j.indices)
    d2_t, i_t = tknn.nnk(torch.from_numpy(ref), torch.from_numpy(nbr), k)
    assert d2_t.dtype == torch.float64 and i_t.shape == (100, k)
    np.testing.assert_allclose(d2_t.numpy(), d2_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(i_t.numpy(), i_j)


@pytest.mark.parametrize('D', [6, 9])
def test_knn_tiled_float64_matches_jax(D):
    """float64 clouds, of 6 and of more than 8 coordinates, take the Gram
    path on the CPU, as the JAX package does off the TPU under x64."""
    import jax
    ref, nbr = (a.astype(np.float64) for a in clouds(D, 100, 200, D))
    with jax.enable_x64(True):
        res_j = jgeo._knn_tiled(jnp.asarray(ref), jnp.asarray(nbr), 4, False,
                                64)
        v_j, i_j = np.asarray(res_j.values), np.asarray(res_j.indices)
    res_t = tgeo.knn(torch.from_numpy(ref), torch.from_numpy(nbr), k=4,
                     chunk=64)
    np.testing.assert_allclose(res_t.values.numpy(), v_j, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(res_t.indices.numpy(), i_j)
