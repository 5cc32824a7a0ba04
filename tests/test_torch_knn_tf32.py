"""The precision scheme of the float32 wide knn scans (``csrc/knn.cu``,
D > 8, on the tensor cores), on the CPU: the TF32 split of
``ops/knn.py:_tf32_split`` and the three-pass cross term of
``_tf32_scores``, the kernels' arithmetic up to the order in which the
tensor cores sum a k-step, against the JAX package's Pallas kernels in
interpret mode on identical numpy inputs.

Tolerance: the near-tie rule the card holds the kernels to
(``testing.nnk_tolerance_failures`` at rtol = atol = 1e-6): each index
equal to the Pallas one or a near-tie, distinct within a row, and each
d^2 within 1e-6 (|a|^2 + |b|^2) + 1e-6 of its pair's float64 d^2.  One
TF32 pass breaks it on FPFH-like clouds, which is why the kernels take
three.
"""

import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pypose_tpu.ops import pallas_knn
from pypose_tpu_torch.ops import knn as tknn
from pypose_tpu_torch.testing import cap_threads, nnk_tolerance_failures

cap_threads()

DIMS = (9, 16, 33, 128)
KINDS = ('fpfh', 'sift', 'ties')
R, N = 130, 270


def clouds(kind, D, seed):
    """Two float32 clouds [R, D] and [N, D]: FPFH-like (uniform bins, each
    row summing to 100), SIFT-like (unit length, clipped at 0.2 and
    normalised again), or FPFH-like neighbours that each appear twice
    (exact ties), with copies of some of them among the reference rows."""
    rng = np.random.default_rng(seed)

    def fpfh(n):
        x = rng.uniform(size=(n, D))
        return 100 * x / x.sum(1, keepdims=True)

    def sift(n):
        x = rng.uniform(size=(n, D))
        x = np.minimum(x / np.linalg.norm(x, axis=1, keepdims=True), 0.2)
        return x / np.linalg.norm(x, axis=1, keepdims=True)
    if kind == 'sift':
        ref, nbr = sift(R), sift(N)
    elif kind == 'fpfh':
        ref, nbr = fpfh(R), fpfh(N)
    else:
        base = fpfh(N // 2)
        nbr = np.concatenate([base, base])
        ref = np.concatenate([base[:R // 2], fpfh(R - R // 2)])
    return ref.astype(np.float32), nbr.astype(np.float32)


@functools.cache
def pallas_indices(kind, D, k):
    """The Pallas kernel's indices (nn1 for k = 1, else nnk), interpret
    mode, tiles smaller than the clouds."""
    ref, nbr = clouds(kind, D, D)
    if k == 1:
        _, idx = pallas_knn.nn1(jnp.asarray(ref), jnp.asarray(nbr), tr=64,
                                tn=128, interpret=True)
        idx = np.asarray(idx)[:, None]
    else:
        _, idx = pallas_knn.nnk(jnp.asarray(ref), jnp.asarray(nbr), k, tr=64,
                                tn=128, interpret=True)
    return torch.from_numpy(np.asarray(idx).astype(np.int64))


@pytest.mark.parametrize('scale', [1e-3, 1.0, 100.0, 3e4])
def test_tf32_split(scale):
    """hi keeps at most 10 explicit mantissa bits, lo too, and hi + lo is
    within 2^-22 |x| of x; hi is x rounded to nearest."""
    rng = np.random.default_rng(int(scale * 1000))
    x = torch.from_numpy((scale * rng.normal(size=4096)).astype(np.float32))
    hi, lo = tknn._tf32_split(x)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    x64, hi64, lo64 = x.double(), hi.double(), lo.double()
    assert bool(((x64 - hi64 - lo64).abs() <= 2.0 ** -22 * x64.abs()).all())
    # to nearest: no other TF32 value lies closer to x
    ulp = 2.0 ** (torch.floor(torch.log2(hi64.abs())) - 10)
    assert bool(((x64 - hi64).abs() <= ulp / 2).all())


def test_tf32_round_ties_away_from_zero():
    """cvt.rna's rule: a value halfway between two TF32 values goes to the
    one of larger magnitude."""
    halfway = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11),
                            1 + 3 * 2.0 ** -11], dtype=torch.float32)
    want = torch.tensor([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1 + 2.0 ** -9],
                        dtype=torch.float32)
    assert torch.equal(tknn._tf32_round(halfway), want)


@pytest.mark.parametrize('k', [1, 2, 8, 16])
@pytest.mark.parametrize('D', DIMS)
@pytest.mark.parametrize('kind', KINDS)
def test_three_pass_matches_pallas(kind, D, k):
    """The three-pass emulation's nn1 (k = 1) and nnk against the Pallas
    kernels under the near-tie rule; d^2 ascending within a row."""
    ref, nbr = (torch.from_numpy(a) for a in clouds(kind, D, D))
    d2, idx = tknn._nnk_tf32(ref, nbr, k)
    assert d2.shape == idx.shape == (R, k) and (d2 >= 0).all()
    assert (d2[:, 1:] >= d2[:, :-1]).all()
    got = nnk_tolerance_failures(ref, nbr, d2, idx,
                                 pallas_indices(kind, D, k))
    assert got['index_failures'] == got['repeat_failures'] \
        == got['d2_failures'] == 0, got
    if kind == 'ties':
        # a neighbour's copy ranks right after it, the lower index first
        if k == 1:
            assert bool((idx[:, 0] < N // 2).all())
        else:
            assert torch.equal(idx[:, 1], idx[:, 0] + N // 2)


def test_one_pass_breaks_the_rule():
    """One TF32 pass (the hardware's own rounding of float32 inputs aside)
    on FPFH-like clouds at D = 33: d^2 off by far more than the rule
    allows, which the three passes hold (the test above)."""
    ref, nbr = (torch.from_numpy(a) for a in clouds('fpfh', 33, 33))
    d2, idx = tknn._nnk_tf32(ref, nbr, 1, passes=1)
    got = nnk_tolerance_failures(ref, nbr, d2, idx,
                                 pallas_indices('fpfh', 33, 1))
    assert got['d2_failures'] > R // 2, got
    tol = 1e-6 * (ref.double() ** 2).sum(1).min() + 1e-6
    assert got['max_d2_err'] > 50 * float(tol), got
