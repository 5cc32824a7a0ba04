"""``sparse/ops.py`` of the port against the JAX package on the same numpy
inputs, in float32 and float64: BSR/BSC conversion (the same index
arrays), ``bsr_bsc_matmul`` over random block patterns with all-zero
blocks, ``bsr_matvec``, ``bsr_to_dense``, the pair list against the JAX
package's Python loop (the same order), the fixed-order segment sums
(several tile levels; two runs give the same bits), the values' device,
and the layout dispatcher raising for anything but BSR x BSC; and
tests/sparse/test_bsr.py's three tests.

Tolerances: products within 1e-12 (float64) and 2e-5 (float32) of
max(1, |A| |B|) entrywise, against JAX and against numpy's float64 dense
product; conversions exact.
"""

from collections import defaultdict

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pypose_tpu.sparse import (bsr_bsc_matmul as jmatmul,
                               bsr_matvec as jmatvec,
                               dense_to_bsc as jto_bsc,
                               dense_to_bsr as jto_bsr)
from pypose_tpu.sparse.ops import _sparse_csr_mm as j_csr_mm
from pypose_tpu_torch.sparse import (BSC, BSR, bsr_bsc_matmul, bsr_matvec,
                                     bsr_to_dense, dense_to_bsc,
                                     dense_to_bsr)
from pypose_tpu_torch.sparse.ops import (_segment_plan, _segment_sum,
                                         _sparse_csr_mm, bsr_bsc_pairs)
from pypose_tpu_torch.testing import cap_threads

cap_threads()

DTYPES = [np.float32, np.float64]
SHAPES = [(2, 3, 4), (3, 3, 3), (1, 2, 1), (6, 3, 6)]


def random_block_dense(rng, nbr, nbc, bh, bw, density=0.4):
    mask = rng.random((nbr, nbc)) < density
    blocks = rng.normal(size=(nbr, nbc, bh, bw)) * mask[..., None, None]
    return blocks.transpose(0, 2, 1, 3).reshape(nbr * bh, nbc * bw)


def tol(dtype):
    return 1e-12 if dtype == np.float64 else 2e-5


def held(got, want, scale, dtype):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    assert (np.abs(got - np.asarray(want, np.float64))
            <= tol(dtype) * np.maximum(scale, 1)).all()


def jax_pairs(bsr, bsc):
    """The JAX package's pair loop (pypose_tpu/sparse/ops.py:81-93)."""
    bw = bsc.values.shape[2]
    nbc = bsc.shape[1] // bw
    nbr = bsr.shape[0] // bsr.values.shape[1]
    a_rows = np.repeat(np.arange(nbr), np.diff(bsr.crow_indices))
    b_cols = np.repeat(np.arange(nbc), np.diff(bsc.ccol_indices))
    b_by_k = defaultdict(list)
    for idx, k in enumerate(bsc.row_indices):
        b_by_k[int(k)].append(idx)
    ai, bi, oi = [], [], []
    for idx_a, k in enumerate(bsr.col_indices):
        for idx_b in b_by_k.get(int(k), ()):
            ai.append(idx_a)
            bi.append(idx_b)
            oi.append(int(a_rows[idx_a]) * nbc + int(b_cols[idx_b]))
    return ai, bi, oi


@pytest.mark.parametrize('bshape', SHAPES)
@pytest.mark.parametrize('dtype', DTYPES)
def test_matmul_matvec_match_jax(dtype, bshape):
    bh, bk, bw = bshape
    rng = np.random.default_rng(sum(bshape))
    A = random_block_dense(rng, 9, 11, bh, bk).astype(dtype)
    B = random_block_dense(rng, 11, 7, bk, bw).astype(dtype)
    a, b = dense_to_bsr(A, (bh, bk), 'cpu'), dense_to_bsc(B, (bk, bw), 'cpu')
    with jax.enable_x64(dtype == np.float64):
        ja, jb = jto_bsr(A, (bh, bk)), jto_bsc(B, (bk, bw))
        want = jmatmul(ja, jb)
        x = rng.normal(size=A.shape[1]).astype(dtype)
        want_mv = jmatvec(ja, jnp.asarray(x))
    for got, ref in ((a, ja), (b, jb)):
        for g, r in zip(got[:2], ref[:2]):
            np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(got.values.numpy(),
                                      np.asarray(ref.values))
        assert got.shape == ref.shape
    assert a.values.dtype == torch.from_numpy(A).dtype
    scale = np.abs(A).astype(np.float64) @ np.abs(B)
    out = bsr_bsc_matmul(a, b)
    held(out, np.asarray(want), scale, dtype)
    held(out, A.astype(np.float64) @ B, scale, dtype)
    held(bsr_matvec(a, torch.tensor(x)), np.asarray(want_mv),
         np.abs(A) @ np.abs(x), dtype)
    pairs, ref = bsr_bsc_pairs(a, b), jax_pairs(ja, jb)
    for p, r in zip(pairs, ref):
        assert p.tolist() == r
    np.testing.assert_array_equal(bsr_to_dense(a).numpy(), A)


def test_segment_sums_fixed_order():
    """Segments of 1 to 700 items (three tile levels) in shuffled list
    order: the sums within 1e-12 of numpy's, empty segments absent, and a
    second run bit for bit."""
    rng = np.random.default_rng(7)
    counts = np.array([1, 700, 0, 16, 17, 255, 256, 257, 3])
    seg = rng.permutation(np.repeat(np.arange(len(counts)), counts))
    x = torch.tensor(rng.normal(size=(len(seg), 2, 3)))
    plan = _segment_plan(seg)
    assert len(plan[0]) == 3
    np.testing.assert_array_equal(plan[2], np.nonzero(counts)[0])
    want = np.zeros((len(counts), 2, 3))
    np.add.at(want, seg, x.numpy())
    got = _segment_sum(x, plan)
    np.testing.assert_allclose(got.numpy(), want[counts > 0], atol=1e-12)
    assert torch.equal(got, _segment_sum(x, plan))


def test_values_device():
    """A numpy input goes to the card unless a device is named; a tensor
    keeps its own device."""
    A = np.kron(np.eye(2), np.ones((2, 2)))
    assert dense_to_bsr(torch.tensor(A), (2, 2)).values.device.type == 'cpu'
    assert dense_to_bsc(A, (2, 2), device='cpu').values.device.type == 'cpu'
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            dense_to_bsr(A, (2, 2))


def test_layout_mismatch_raises():
    A = np.kron(np.eye(2), np.ones((2, 2)))
    a, b = dense_to_bsr(A, (2, 2), 'cpu'), dense_to_bsc(A, (2, 2), 'cpu')
    np.testing.assert_array_equal(_sparse_csr_mm(a, b).numpy(), A @ A)
    for x, y in ((b, a), (a, a), (b, b)):
        with pytest.raises(NotImplementedError):
            _sparse_csr_mm(x, y)
    with pytest.raises(NotImplementedError):
        j_csr_mm(jto_bsc(A, (2, 2)), jto_bsr(A, (2, 2)))
    assert isinstance(a, BSR) and isinstance(b, BSC)


# --- tests/sparse/test_bsr.py's three tests, on the port -----------------

@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('bshape', [(2, 3, 4), (3, 3, 3), (1, 2, 1)])
def test_bsr_bsc_matmul_matches_dense(seed, bshape):
    bh, bk, bw = bshape
    rng = np.random.default_rng(seed)
    A = random_block_dense(rng, 4, 5, bh, bk)
    B = random_block_dense(rng, 5, 3, bk, bw)
    out = bsr_bsc_matmul(dense_to_bsr(A, (bh, bk), 'cpu'),
                         dense_to_bsc(B, (bk, bw), 'cpu'))
    np.testing.assert_allclose(out.numpy(), A @ B, atol=1e-5)


def test_bsr_roundtrip_and_matvec():
    rng = np.random.default_rng(3)
    A = random_block_dense(rng, 3, 4, 2, 2)
    bsr = dense_to_bsr(A, (2, 2), 'cpu')
    np.testing.assert_allclose(bsr_to_dense(bsr).numpy(), A, atol=1e-6)
    x = rng.normal(size=8)
    np.testing.assert_allclose(bsr_matvec(bsr, torch.tensor(x)).numpy(),
                               A @ x, atol=1e-5)


def test_all_zero_blocks():
    A = np.zeros((4, 6))
    B = np.zeros((6, 4))
    a, b = dense_to_bsr(A, (2, 2), 'cpu'), dense_to_bsc(B, (2, 2), 'cpu')
    assert a.values.shape == (0, 2, 2) and b.values.shape == (0, 2, 2)
    np.testing.assert_allclose(bsr_bsc_matmul(a, b).numpy(), 0.0)
    np.testing.assert_allclose(bsr_matvec(a, torch.ones(6, dtype=torch.float64)
                                          ).numpy(), 0.0)
