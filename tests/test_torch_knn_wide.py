"""The nearest-neighbour plain versions at more than 8 coordinates (the
clouds the wide scans of ``csrc/knn.cu`` take: FPFH descriptors are 33-D,
SIFT's 128-D) against the JAX package's Pallas kernels in interpret mode,
on identical numpy inputs.

Tolerance: the near-tie rule the card holds the kernels to
(``testing.nnk_tolerance_failures``): each index equal to the Pallas one
or a near-tie, distinct within a row, and each d^2 within
1e-6 (|a|^2 + |b|^2) + 1e-6 of its pair's float64 d^2.  Tiles ``tr`` /
``tn`` smaller than the clouds, and row counts that are not multiples of
them, cover the Pallas kernels' padding.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pypose_tpu.function import geometry as jgeo
from pypose_tpu.ops import pallas_knn
from pypose_tpu_torch.function import geometry as tgeo
from pypose_tpu_torch.ops import knn as tknn
from pypose_tpu_torch.testing import (cap_threads, nn1_tolerance_failures,
                                      nnk_tolerance_failures)

cap_threads()

DIMS = (9, 16, 33, 128)


def clouds(seed, R, N, D, kind='normal'):
    """Two float32 clouds: normal draws, or nonnegative histogram-like
    descriptors (uniform draws, each row scaled to sum to 100, as FPFH's
    bins do)."""
    rng = np.random.default_rng(seed)
    if kind == 'normal':
        return (rng.normal(size=(R, D)).astype(np.float32),
                rng.normal(size=(N, D)).astype(np.float32))
    a, b = rng.uniform(size=(R, D)), rng.uniform(size=(N, D))
    return ((100 * a / a.sum(1, keepdims=True)).astype(np.float32),
            (100 * b / b.sum(1, keepdims=True)).astype(np.float32))


def assert_rule(got):
    assert got['index_failures'] == got['repeat_failures'] \
        == got['d2_failures'] == 0, got


@pytest.mark.parametrize('kind', ['normal', 'descriptor'])
@pytest.mark.parametrize('D', DIMS)
def test_nn1_plain_matches_pallas(D, kind):
    ref, nbr = clouds(D, 203, 300, D, kind)
    d2_t, idx_t = tknn.nn1(torch.from_numpy(ref), torch.from_numpy(nbr))
    _, idx_j = pallas_knn.nn1(jnp.asarray(ref), jnp.asarray(nbr), tr=64,
                              tn=128, interpret=True)
    assert d2_t.shape == (203,) and idx_t.dtype == torch.int64
    assert (d2_t >= 0).all()
    assert_rule(nn1_tolerance_failures(
        torch.from_numpy(ref), torch.from_numpy(nbr), d2_t, idx_t,
        torch.from_numpy(np.asarray(idx_j).astype(np.int64))))


# k = 16 (the Pallas merge unrolls k^2 steps: ~10 s a case) at D = 33 only
@pytest.mark.parametrize('D,k', [(D, k) for D in DIMS for k in (2, 8)]
                         + [(33, 16)])
def test_nnk_plain_matches_pallas(D, k):
    ref, nbr = clouds(100 + D + k, 130, 270, D)
    d2_t, idx_t = tknn.nnk(torch.from_numpy(ref), torch.from_numpy(nbr), k)
    _, idx_j = pallas_knn.nnk(jnp.asarray(ref), jnp.asarray(nbr), k, tr=64,
                              tn=128, interpret=True)
    assert d2_t.shape == (130, k)
    assert (d2_t[:, 1:] >= d2_t[:, :-1]).all()
    assert_rule(nnk_tolerance_failures(
        torch.from_numpy(ref), torch.from_numpy(nbr), d2_t, idx_t,
        torch.from_numpy(np.asarray(idx_j).astype(np.int64))))


def test_nn1_exact_ties_take_the_first_index():
    """Duplicated neighbours at D = 33: both packages take the lower
    index."""
    ref, nbr = clouds(7, 64, 100, 33)
    nbr = np.concatenate([nbr, nbr])           # every point twice
    _, idx_t = tknn.nn1(torch.from_numpy(ref), torch.from_numpy(nbr))
    _, idx_j = pallas_knn.nn1(jnp.asarray(ref), jnp.asarray(nbr), tr=64,
                              tn=128, interpret=True)
    assert (idx_t.numpy() < 100).all()
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))


@pytest.mark.parametrize('k', [1, 4])
def test_knn_tiled_wide_matches_jax(k):
    """``knn`` through the chunked Gram route at D = 33 against the JAX
    package's ``knn`` with the same chunk."""
    ref, nbr = clouds(11, 150, 220, 33, 'descriptor')
    got = tgeo.knn(torch.from_numpy(ref), torch.from_numpy(nbr), k=k,
                   chunk=64)
    want = jgeo.knn(jnp.asarray(ref), jnp.asarray(nbr), k=k, chunk=64)
    assert_rule(nnk_tolerance_failures(
        torch.from_numpy(ref), torch.from_numpy(nbr), got.values ** 2,
        got.indices,
        torch.from_numpy(np.asarray(want.indices).astype(np.int64))))
