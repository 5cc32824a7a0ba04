"""The CPU emulation of ``nnk``'s select-then-sort path for the wide
families (D > 8, ``csrc/knn.cu:launch_nnk_wide_select``):
``ops/knn.py:_select_rows`` over ``_tf32_scores``, the three-pass TF32
scores that the float32 tensor-core passes form, or over
``_select_scores``, the float64 scores that the DMMA passes form in
another rounding order (``_nnk_select`` joins them for clouds past 8
coordinates).  Nothing on the card's path runs the emulation; the card
tests hold the kernel to the tensor-core merge scan bit for bit.

Held here, on identical numpy clouds, in float32 and float64 (JAX under
``jax.enable_x64``, as ``test_torch_knn_bigk.py`` runs it):

- the cut and sort against a stable sort of the same scores, bit for bit,
  exact (no boundary buffer) and with boundary buffers of 8 pairs, where
  the index digits run;
- ``_nnk_select`` against the JAX package's ``lax.top_k`` route
  (``pypose_tpu/function/geometry.py:_knn_tiled``, chunks of 64 rows) at
  D = 33 and 128, k = 32, 257 and N (64 x 300 clouds), and against
  ``pallas_knn.nnk`` in interpret mode at k = 4 (its merge unrolls k^2
  steps: k = 8 compiles in ~3 s on the CPU, k = 17 in ~19 s, so the
  larger k go to ``lax.top_k``), under
  ``test_torch_knn_bigk.assert_agree``'s rule (d^2 within
  1e-6 (|a|^2 + |b|^2) + 1e-6; indices equal at every clear rank);
- on integer clouds, whose TF32 splits (float64: whose products and
  sums) are exact, the indices equal the JAX package's everywhere, ties
  lower index first.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pypose_tpu.function import geometry as jgeo
from pypose_tpu.ops import pallas_knn
from pypose_tpu_torch.ops import knn as tknn
from pypose_tpu_torch.testing import cap_threads
from test_torch_knn_bigk import assert_agree, clouds

cap_threads()


def _jax_top_k(ref, nbr, k):
    with jax.enable_x64(ref.dtype == np.float64):
        res = jgeo._knn_tiled(jnp.asarray(ref), jnp.asarray(nbr), k, False,
                              64)
        return np.asarray(res.values) ** 2, np.asarray(res.indices)


def _wide_scores(ref, nbr):
    """The wide family's scores of ``ref`` and ``nbr`` (numpy): the
    three-pass TF32 ones in float32, the FMA chain's in float64."""
    rt, nt = torch.from_numpy(ref), torch.from_numpy(nbr)
    if ref.dtype == np.float32:
        return tknn._tf32_scores(rt, nt)
    return tknn._select_scores(rt, nt)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('cap', [0, 8])
@pytest.mark.parametrize('D', [33, 128])
@pytest.mark.parametrize('k', [32, 257, 300])
def test_wide_cut_is_a_stable_sort_of_the_tf32_scores(k, D, cap, dtype):
    """The digit cut over the wide family's scores (float32: three-pass
    TF32; float64: 8 key digits, then the index's), exact and with a
    boundary buffer of 8 pairs, gives a stable sort's first k of the same
    scores, indices and values."""
    ref, nbr = clouds(k + D, 64, 300, D, dtype)
    s = _wide_scores(ref, nbr)
    assert s.dtype == torch.from_numpy(ref).dtype
    v, i, passes = tknn._select_rows(s, k, cap)
    v_s, i_s = torch.sort(s, dim=1, stable=True)
    assert torch.equal(i, i_s[:, :k]) and torch.equal(v, v_s[:, :k])
    assert passes == 0 if k == 300 else passes >= 1


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('D', [33, 128])
@pytest.mark.parametrize('k', [32, 257, 300])
def test_wide_select_matches_jax_top_k(k, D, dtype):
    """``_nnk_select`` on 64 x 300 clouds (the wide family's scores:
    three-pass TF32 in float32) against the JAX package's ``_knn_tiled``
    and the plain ``_nnk_torch``, at k = 32, 257 and N."""
    ref, nbr = clouds(k + 10 * D, 64, 300, D, dtype)
    rt, nt = torch.from_numpy(ref), torch.from_numpy(nbr)
    d2_e, idx_e = tknn._nnk_select(rt, nt, k)
    assert d2_e.dtype == rt.dtype and idx_e.dtype == torch.int64
    assert (torch.diff(d2_e, dim=1) >= 0).all()
    assert_agree(ref, nbr, d2_e, idx_e, *_jax_top_k(ref, nbr, k))
    d2_p, idx_p = tknn._nnk_torch(rt, nt, k)
    assert_agree(ref, nbr, d2_e, idx_e, d2_p, idx_p)


@pytest.mark.parametrize('D', [33, 128])
def test_wide_select_matches_pallas(D):
    """``_nnk_select`` against the Pallas kernel in interpret mode at
    k = 4 on 64 x 512 clouds (tiles of 64 x 128)."""
    ref, nbr = clouds(4 + D, 64, 512, D)
    d2_e, idx_e = tknn._nnk_select(torch.from_numpy(ref),
                                   torch.from_numpy(nbr), 4)
    d2_j, idx_j = pallas_knn.nnk(jnp.asarray(ref), jnp.asarray(nbr), 4,
                                 tr=64, tn=128, interpret=True)
    assert_agree(ref, nbr, d2_e, idx_e, d2_j, idx_j)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('D', [33, 128])
@pytest.mark.parametrize('k', [40, 250, 500])
def test_wide_select_integer_ties(k, D, dtype):
    """Small-integer clouds, every neighbour twice: every TF32 split,
    product and sum is exact (float64: every product and sum), so the
    scores are, and runs of equal ones straddle the k-th pair (cut by
    index, with a boundary buffer of 8); the emulation's indices and
    distances equal the JAX package's and the plain version's everywhere,
    the lower index first."""
    rng = np.random.default_rng(k + D)
    base = rng.integers(0, 3, size=(250, D)).astype(dtype)
    nbr = np.concatenate([base, base])
    ref = rng.integers(0, 3, size=(40, D)).astype(dtype)
    rt, nt = torch.from_numpy(ref), torch.from_numpy(nbr)
    d2_e, idx_e = tknn._nnk_select(rt, nt, k, cap=8)
    d2_j, idx_j = _jax_top_k(ref, nbr, k)
    np.testing.assert_array_equal(idx_e.numpy(), idx_j)
    np.testing.assert_array_equal(d2_e.numpy(), np.round(d2_j))
    d2_p, idx_p = tknn._nnk_torch(rt, nt, k)
    assert torch.equal(idx_e, idx_p) and torch.equal(d2_e, d2_p)
    same = d2_e[:, 1:] == d2_e[:, :-1]
    assert bool(same.any())
    assert bool((idx_e[:, 1:][same] > idx_e[:, :-1][same]).all())
