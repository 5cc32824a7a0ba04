"""``nnk`` at k > 16 (the CUDA kernel's lists off the registers) on the CPU:
the plain version ``ops/knn.py:_nnk_torch`` and ``function/geometry.py:
knn`` / ``_knn_tiled`` (the chunked Gram route on the CPU) against the JAX
package on identical numpy inputs: the Pallas kernel in interpret mode
(``pallas_knn.nnk``) at k = 17, and the ``lax.map`` + ``lax.top_k`` route
(``geometry._knn_tiled``) at k = 32, 100 and N, at 3, 6 and 33
coordinates, in float32 and float64, and on either side of the card's
crossovers from the merge scan to select-then-sort (``csrc/knn.cu``'s
``kSelectKSmallR``, ``kSelectKSmallR64``, ``kSelectK``, ``kSelectK64``)
at 3 and 6.

Tolerance (``test_torch_knn.py:assert_knn_agree``'s rule): squared
distances within rtol (|a|^2 + |b|^2) + rtol of the JAX ones, rtol 1e-6 in
float32 and 1e-12 in float64 (the Gram form's cancellation: a few ulps of
the terms that cancel); indices equal at every rank whose float64 distance
is clear of its neighbours' by more than that, and everywhere on exact
ties (integer points), where both packages take the lower index.  The
Pallas merge unrolls k^2 steps: k = 17 compiles in ~19 s on the CPU, k =
24 in more than 3 minutes, so only k = 17 runs against it.
"""

import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pypose_tpu.function import geometry as jgeo
from pypose_tpu.ops import pallas_knn
from pypose_tpu_torch.function import geometry as tgeo
from pypose_tpu_torch.ops import knn as tknn
from pypose_tpu_torch.testing import cap_threads

cap_threads()

RTOL = {np.float32: 1e-6, np.float64: 1e-12}


def _crossover(name):
    """A crossover constant of csrc/knn.cu, read from the source (the
    card's library holds it; ops.knn.select_k needs the card)."""
    src = (Path(tknn.__file__).resolve().parents[1] / 'csrc'
           / 'knn.cu').read_text()
    return int(re.search(rf'constexpr int {name} = (\d+);', src).group(1))


SMALL_R, SMALL_R64, LARGE_R, LARGE_R64 = (_crossover(n) for n in (
    'kSelectKSmallR', 'kSelectKSmallR64', 'kSelectK', 'kSelectK64'))


def clouds(seed, R, N, D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(R, D)).astype(dtype),
            rng.normal(size=(N, D)).astype(dtype))


def assert_agree(ref, nbr, d2_t, idx_t, d2_j, idx_j):
    """[R, k] results of the port and of JAX for the same clouds, under
    the module's rule."""
    d2_t, idx_t = np.asarray(d2_t), np.asarray(idx_t)
    d2_j, idx_j = np.asarray(d2_j), np.asarray(idx_j)
    rtol = RTOL[ref.dtype.type]
    assert d2_t.shape == d2_j.shape == idx_t.shape == idx_j.shape
    assert d2_t.dtype == ref.dtype and idx_t.dtype == np.int64
    r64, n64 = ref.astype(np.float64), nbr.astype(np.float64)
    an = (r64 ** 2).sum(-1)[:, None]
    tol = rtol * (an + (n64 ** 2).sum(-1)[idx_j]) + rtol
    assert (np.abs(d2_t - d2_j) <= tol).all()
    k = d2_t.shape[1]
    exact = np.sort(((r64[:, None] - n64[None]) ** 2).sum(-1), axis=1)
    # a rank is clear when it is apart from the ranks beside it (the last
    # rank of a whole row has no rank after it)
    ext = np.concatenate([exact, np.full((len(exact), 1), np.inf)], 1)
    gap = np.diff(ext[:, :k + 1], axis=1) > tol
    clear = np.concatenate([gap[:, :1], gap[:, :-1] & gap[:, 1:]], 1)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(idx_t[clear], idx_j[clear])


def test_plain_matches_pallas_k17():
    """The plain version against the Pallas kernel in interpret mode at
    k = 17, past the CUDA kernel's register lists, with tiles (64 x 128)
    smaller than the clouds and a padded last tile of each."""
    ref, nbr = clouds(17, 70, 200, 3)
    d2_t, idx_t = tknn.nnk(torch.from_numpy(ref), torch.from_numpy(nbr), 17)
    d2_j, idx_j = pallas_knn.nnk(jnp.asarray(ref), jnp.asarray(nbr), 17,
                                 tr=64, tn=128, interpret=True)
    assert_agree(ref, nbr, d2_t, idx_t, d2_j, idx_j)
    assert (np.diff(d2_t.numpy(), axis=1) >= 0).all()


# k on either side of the card's crossovers for up to 8 coordinates
# (csrc/knn.cu: kSelectKSmallR and kSelectKSmallR64 up to 32,768 rows,
# kSelectK and kSelectK64 past them; ops.knn.select_k), where nnk turns
# from the warp merge scan to select-then-sort: (k, dtype), each at D = 3
# and 6
SIDE_KS = ((SMALL_R - 1, np.float32), (SMALL_R, np.float32),
           (SMALL_R64 - 1, np.float64), (SMALL_R64, np.float64),
           (LARGE_R - 1, np.float32), (LARGE_R, np.float32),
           (LARGE_R64 - 1, np.float64), (LARGE_R64, np.float64))
TOP_K_CASES = ([(k, D, dt) for dt in (np.float32, np.float64)
                for D in (3, 6, 33) for k in (32, 100, 300)]
               + [(k, D, dt) for k, dt in SIDE_KS for D in (3, 6)])


@pytest.mark.parametrize('k,D,dtype', TOP_K_CASES)
def test_plain_and_tiled_match_jax_top_k(k, D, dtype):
    """``nnk``'s plain version, ``_knn_tiled`` and ``knn`` with a chunk
    (150 rows in chunks of 64) against the JAX package's ``_knn_tiled``
    (``lax.map`` over chunks, ``lax.top_k``) at k = 32, 100 and N = 300,
    and on either side of the card's crossovers (N = k + 13 past 300)."""
    ref, nbr = clouds(k + D, 150, 300 if k <= 300 else k + 13, D, dtype)
    with jax.enable_x64(dtype == np.float64):
        res_j = jgeo._knn_tiled(jnp.asarray(ref), jnp.asarray(nbr), k,
                                False, 64)
        v_j, i_j = np.asarray(res_j.values), np.asarray(res_j.indices)
    rt, nt = torch.from_numpy(ref), torch.from_numpy(nbr)
    d2_t, idx_t = tknn.nnk(rt, nt, k)
    assert_agree(ref, nbr, d2_t, idx_t, v_j ** 2, i_j)
    for res_t in (tgeo._knn_tiled(rt, nt, k, False, 64),
                  tgeo.knn(rt, nt, k=k, chunk=64)):
        assert res_t.values.dtype == rt.dtype
        assert_agree(ref, nbr, res_t.values.numpy() ** 2, res_t.indices,
                     v_j ** 2, i_j)


@pytest.mark.parametrize('k,dtype', [(40, np.float32), (40, np.float64),
                                     *SIDE_KS])
def test_exact_ties_take_the_lower_index(k, dtype):
    """Integer points, every neighbour twice (k past 150: as often as k
    needs): the distances are exact in both packages and both order equal
    ones by index, so at k = 40 and on either side of the card's
    crossovers the indices are equal everywhere."""
    rng = np.random.default_rng(40)
    base = rng.integers(0, 4, size=(150, 3)).astype(dtype)
    nbr = np.concatenate([base] * max(2, -(-(k + 1) // 150)))
    ref = rng.integers(0, 4, size=(60, 3)).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        res_j = jgeo._knn_tiled(jnp.asarray(ref), jnp.asarray(nbr), k,
                                False, 64)
        v_j, i_j = np.asarray(res_j.values), np.asarray(res_j.indices)
    d2_t, idx_t = tknn.nnk(torch.from_numpy(ref), torch.from_numpy(nbr), k)
    np.testing.assert_array_equal(idx_t.numpy(), i_j)
    # JAX returns distances: integers' square roots, rounded once in both
    np.testing.assert_array_equal(np.sqrt(d2_t.numpy()), v_j)
    res_t = tgeo.knn(torch.from_numpy(ref), torch.from_numpy(nbr), k=k,
                     chunk=64)
    np.testing.assert_array_equal(res_t.indices.numpy(), i_j)
    # equal distances in ascending index: every original before the
    # copies (index 150 + j)
    d2, idx = d2_t.numpy(), idx_t.numpy()
    same = d2[:, 1:] == d2[:, :-1]
    assert same.any() and (idx >= 150).any()
    assert (idx[:, 1:][same] > idx[:, :-1][same]).all()


def test_nnk_takes_any_k_up_to_n():
    """``ops.knn.nnk`` on the CPU takes every k up to N, as the Pallas
    kernel does, and refuses k > N with the JAX function's error; no
    ``MAX_K`` bounds it any more."""
    ref, nbr = clouds(3, 20, 50, 3)
    rt, nt = torch.from_numpy(ref), torch.from_numpy(nbr)
    d2, idx = tknn.nnk(rt, nt, 50)
    assert d2.shape == idx.shape == (20, 50)
    assert (np.sort(idx.numpy(), 1) == np.arange(50)).all()
    with pytest.raises(ValueError, match='k=51'):
        tknn.nnk(rt, nt, 51)
    with pytest.raises(ValueError, match='k=51'):
        pallas_knn.nnk(jnp.asarray(ref), jnp.asarray(nbr), 51,
                       interpret=True)
    assert not hasattr(tknn, 'MAX_K')
