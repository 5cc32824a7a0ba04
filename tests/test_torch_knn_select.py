"""The CPU emulation of ``nnk``'s select-then-sort path
(``ops/knn.py:_select_keys``, ``_select_rows``, ``_nnk_select``): the key
map, the (key, index) threshold cut digit by digit with its index cut,
and the sort, as ``csrc/knn.cu:launch_nnk_select`` runs them.  Nothing on
the card's path runs the emulation; the card tests hold the kernel to it
on exact ties.

Held here:

- the key map against the float order, on -0/+0, +-inf, subnormals and
  random values (-0 and +0 one key, as the (s, index) order holds them
  equal);
- the selection against a stable sort of the same scores, bit for bit, on
  random scores, on runs of exact ties that straddle the k-th pair, and
  on +-0 and +inf, with boundary buffers small enough that the index
  digits run;
- ``_nnk_select`` against the JAX package's ``lax.top_k`` route
  (``pypose_tpu/function/geometry.py:_knn_tiled``) and the plain
  ``_nnk_torch`` on identical numpy clouds, at k = 32, 257 and N, D = 3
  and 6, float32 and float64, under ``test_torch_knn_bigk.assert_agree``'s
  rule (d^2 within rtol (|a|^2 + |b|^2) + rtol, rtol 1e-6 in float32 and
  1e-12 in float64; indices equal at every clear rank); on integer
  clouds, whose scores are exact, indices equal everywhere.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pypose_tpu.function import geometry as jgeo
from pypose_tpu_torch.ops import knn as tknn
from pypose_tpu_torch.testing import cap_threads
from test_torch_knn_bigk import assert_agree, clouds

cap_threads()

DTYPES = [torch.float32, torch.float64]


def _stable(s, k):
    v, i = torch.sort(s, dim=1, stable=True)
    return v[:, :k], i[:, :k]


@pytest.mark.parametrize('dtype', DTYPES)
def test_keys_follow_the_float_order(dtype):
    """Keys ascend as the values do; -0 and +0 share a key; +inf is
    last, -inf first, subnormals in place."""
    tiny = torch.finfo(dtype).tiny
    special = torch.tensor([-float('inf'), -3.5, -tiny / 4, -0.0, 0.0,
                            tiny / 4, 1.0, float('inf')], dtype=dtype)
    rng = np.random.default_rng(7)
    vals = torch.cat([special, torch.from_numpy(
        rng.standard_normal(500) * 10.0 ** rng.integers(-30, 30, 500)
    ).to(dtype)])
    keys = tknn._select_keys(vals[None])[0]
    if dtype == torch.float64:   # 64-bit keys compare as unsigned
        keys = keys ^ torch.iinfo(torch.int64).min
    order = torch.sort(vals, stable=True).indices
    assert (torch.diff(keys[order]) >= 0).all()
    assert keys[3] == keys[4]                       # -0, +0
    assert (keys[order][1:] > keys[order][:-1]).sum() == len(vals) - 2
    assert keys[0] == keys.min() and keys[7] == keys.max()


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('R,N,k,cap', [
    (6, 300, 32, 0), (6, 300, 257, 0), (6, 300, 300, 0),
    (6, 1000, 100, 8), (6, 1000, 1, 1), (3, 70_000, 500, 16)])
def test_selection_is_a_stable_sort(R, N, k, cap, dtype):
    """Random scores, and small integers with -0 for 0 and every 7th
    score +inf (runs of exact ties across the k-th pair): the emulated
    cut and sort give a stable sort's first k, indices and values, with
    no boundary buffer (the exact cut) and with one of 1, 8 or 16 pairs,
    where the tied rows cut by index digits (more passes than the key
    has digits)."""
    gen = torch.Generator().manual_seed(R * N + k)
    s = torch.randn((R, N), generator=gen, dtype=dtype)
    v, i, _ = tknn._select_rows(s, k, cap)
    v_s, i_s = _stable(s, k)
    assert torch.equal(i, i_s) and torch.equal(v, v_s)
    s = torch.randint(-3, 4, (R, N), generator=gen).to(dtype)
    s[s == 0] = -0.0
    s[:, ::7] = float('inf')
    v, i, passes = tknn._select_rows(s, k, cap)
    v_s, i_s = _stable(s, k)
    assert torch.equal(i, i_s) and torch.equal(v, v_s)
    if 0 < cap < 256:
        key_digits = 4 if dtype == torch.float32 else 8
        assert passes > key_digits


def test_selection_refuses_k_above_n():
    with pytest.raises(ValueError, match='k=11'):
        tknn._select_rows(torch.zeros((2, 10)), 11)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('D', [3, 6])
@pytest.mark.parametrize('k', [32, 257, 300])
def test_select_matches_jax_top_k(k, D, dtype):
    """``_nnk_select`` on 150 x 300 clouds against the JAX package's
    ``_knn_tiled`` (``lax.map`` over chunks of 64, ``lax.top_k``) and the
    plain ``_nnk_torch``, at k = 32, 257 and N = 300."""
    ref, nbr = clouds(k + 10 * D, 150, 300, D, dtype)
    with jax.enable_x64(dtype == np.float64):
        res_j = jgeo._knn_tiled(jnp.asarray(ref), jnp.asarray(nbr), k,
                                False, 64)
        v_j, i_j = np.asarray(res_j.values), np.asarray(res_j.indices)
    rt, nt = torch.from_numpy(ref), torch.from_numpy(nbr)
    d2_e, idx_e = tknn._nnk_select(rt, nt, k)
    assert_agree(ref, nbr, d2_e, idx_e, v_j ** 2, i_j)
    d2_p, idx_p = tknn._nnk_torch(rt, nt, k)
    assert_agree(ref, nbr, d2_e, idx_e, d2_p, idx_p)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('k', [40, 257, 600])
def test_select_integer_ties_straddle_the_kth_pair(k, dtype):
    """Integer points, every neighbour three times: distances are exact
    in both packages and runs of equal ones span the k-th pair, so the
    cut goes by index; the emulation's indices and distances equal the
    JAX package's and the plain version's everywhere, the lower index
    first."""
    rng = np.random.default_rng(k)
    base = rng.integers(0, 4, size=(250, 3)).astype(dtype)
    nbr = np.concatenate([base, base, base])
    ref = rng.integers(0, 4, size=(40, 3)).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        res_j = jgeo._knn_tiled(jnp.asarray(ref), jnp.asarray(nbr), k,
                                False, 64)
        v_j, i_j = np.asarray(res_j.values), np.asarray(res_j.indices)
    rt, nt = torch.from_numpy(ref), torch.from_numpy(nbr)
    d2_e, idx_e = tknn._nnk_select(rt, nt, k, cap=8)
    np.testing.assert_array_equal(idx_e.numpy(), i_j)
    np.testing.assert_array_equal(np.sqrt(d2_e.numpy()), v_j)
    d2_p, idx_p = tknn._nnk_torch(rt, nt, k)
    assert torch.equal(idx_e, idx_p) and torch.equal(d2_e, d2_p)
    # the k-th pair sits inside a run of equal distances in some row
    d2 = np.sqrt(d2_e.numpy())
    full = np.sort(np.sqrt(((ref[:, None] - nbr[None]) ** 2).sum(-1)), 1)
    assert (full[:, k] == d2[:, -1]).any()
