"""``knn`` and ``knn_filter`` with k above the number of points: the JAX
package raises ``ValueError`` (``jax.lax.top_k``: "k argument to top_k
must be no larger than size along axis") on every path, and so does the
port, before any kernel or sort runs.  Same numpy inputs to both; k = N
still returns, with the JAX package's indices.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pypose_tpu.function import geometry as jgeo
from pypose_tpu_torch.function import geometry as tgeo
from pypose_tpu_torch.testing import cap_threads

cap_threads()


def _pair():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((4, 3)).astype(np.float32),
            rng.standard_normal((5, 3)).astype(np.float32))


@pytest.mark.parametrize('chunk', [None, 2])
def test_knn_k_above_n_raises_as_jax_does(chunk):
    """ref (4, 3), nbr (5, 3), k = 7: the dense path (chunk None) and the
    chunked one (chunk 2) raise ValueError in both packages."""
    ref, nbr = _pair()
    with pytest.raises(ValueError):
        jgeo.knn(jnp.asarray(ref), jnp.asarray(nbr), k=7, chunk=chunk)
    with pytest.raises(ValueError, match='k=7'):
        tgeo.knn(torch.from_numpy(ref), torch.from_numpy(nbr), k=7,
                 chunk=chunk)


@pytest.mark.parametrize('largest', [False, True])
@pytest.mark.parametrize('chunk', [None, 2])
def test_knn_k_equal_n_returns_jax_indices(chunk, largest):
    """k = N is the largest k either package takes: N columns, the same
    indices and, within float32 rounding, the same distances."""
    ref, nbr = _pair()
    res_j = jgeo.knn(jnp.asarray(ref), jnp.asarray(nbr), k=5, chunk=chunk,
                     largest=largest)
    res_t = tgeo.knn(torch.from_numpy(ref), torch.from_numpy(nbr), k=5,
                     chunk=chunk, largest=largest)
    assert res_t.indices.shape == (4, 5)
    np.testing.assert_array_equal(res_t.indices.numpy(),
                                  np.asarray(res_j.indices))
    np.testing.assert_allclose(res_t.values.numpy(),
                               np.asarray(res_j.values), rtol=1e-5,
                               atol=1e-5)


def test_batched_knn_k_above_n_raises_as_jax_does():
    """Batched clouds take the dense path: k above N raises there too."""
    rng = np.random.default_rng(1)
    ref = rng.standard_normal((2, 4, 3)).astype(np.float32)
    nbr = rng.standard_normal((2, 6, 3)).astype(np.float32)
    with pytest.raises(ValueError):
        jgeo.knn(jnp.asarray(ref), jnp.asarray(nbr), k=7)
    with pytest.raises(ValueError, match='k=7'):
        tgeo.knn(torch.from_numpy(ref), torch.from_numpy(nbr), k=7)


@pytest.mark.parametrize('radius', [None, 0.8])
def test_knn_filter_k_above_points_raises_as_jax_does(radius):
    """knn_filter takes the k + 1 nearest points: k + 1 above the points
    (all of them, or those the radius leaves) raises in both packages;
    k + 1 = N returns the JAX package's means."""
    rng = np.random.default_rng(2)
    pts = rng.standard_normal((6, 3)).astype(np.float32)
    k = 6 if radius is None else 3
    with pytest.raises(ValueError):
        jgeo.knn_filter(jnp.asarray(pts), k, radius=radius)
    with pytest.raises(ValueError, match=f'k={k + 1}'):
        tgeo.knn_filter(torch.from_numpy(pts), k, radius=radius)
    np.testing.assert_allclose(
        tgeo.knn_filter(torch.from_numpy(pts), 5).numpy(),
        np.asarray(jgeo.knn_filter(jnp.asarray(pts), 5)), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize('k', [-1, -3])
@pytest.mark.parametrize('chunk', [None, 2])
def test_knn_negative_k_raises_as_jax_does(chunk, k):
    """ref (4, 3), nbr (5, 3) from default_rng(0), k = -1 and -3: the
    dense path (chunk None) and the chunked one (chunk 2) raise ValueError
    in both packages (``jax.lax.top_k``: k must be nonnegative)."""
    rng = np.random.default_rng(0)
    ref = rng.standard_normal((4, 3)).astype(np.float32)
    nbr = rng.standard_normal((5, 3)).astype(np.float32)
    with pytest.raises(ValueError):
        jgeo.knn(jnp.asarray(ref), jnp.asarray(nbr), k=k, chunk=chunk)
    with pytest.raises(ValueError, match=f'k={k} must be nonnegative'):
        tgeo.knn(torch.from_numpy(ref), torch.from_numpy(nbr), k=k,
                 chunk=chunk)


def test_knn_k_zero_returns_no_columns_as_jax_does():
    """k = 0 is no fault: on the dense path both packages return (R, 0)
    (the JAX package's chunked path divides by k there)."""
    ref, nbr = _pair()
    res_j = jgeo.knn(jnp.asarray(ref), jnp.asarray(nbr), k=0)
    res_t = tgeo.knn(torch.from_numpy(ref), torch.from_numpy(nbr), k=0)
    assert tuple(res_t.indices.shape) == tuple(res_j.indices.shape) == (4, 0)
    assert tuple(res_t.values.shape) == (4, 0)


def test_knn_filter_negative_k_raises_as_jax_does():
    """knn_filter on a (6, 3) cloud from default_rng(0) at k = -2 with
    radius 1.0: a top-(k + 1) of -1 raises ValueError in both packages
    (the port reached torch.topk and raised RuntimeError before); k = -1
    (a top-0) returns in both, with the same shape."""
    pts = np.random.default_rng(0).standard_normal((6, 3)).astype(np.float32)
    with pytest.raises(ValueError):
        jgeo.knn_filter(jnp.asarray(pts), -2, radius=1.0)
    with pytest.raises(ValueError, match='k=-1 must be nonnegative'):
        tgeo.knn_filter(torch.from_numpy(pts), -2, radius=1.0)
    out_j = np.asarray(jgeo.knn_filter(jnp.asarray(pts), -1, radius=1.0))
    out_t = tgeo.knn_filter(torch.from_numpy(pts), -1, radius=1.0).numpy()
    assert out_t.shape == out_j.shape
