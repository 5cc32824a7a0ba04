"""The rule that holds the ``nnk`` kernel to its plain version
(``pypose_tpu_torch.testing.nnk_tolerance_failures``), on built cases:
exact duplicate neighbours, where the plain version takes the lower index
first and a swap passes as a tie; a near-tie at the k-th position inside
the tolerance; a clear miss outside it; a repeated index within a row; a
distance off its pair.  The plain version itself is held against the JAX
package in ``test_torch_knn.py``.
"""

import pytest
import torch

from pypose_tpu_torch.ops import knn
from pypose_tpu_torch.testing import nnk_tolerance_failures
from pypose_tpu_torch.testing import cap_threads

cap_threads()


def _clouds(seed=0, R=64, N=300):
    gen = torch.Generator().manual_seed(seed)
    return (5.0 * torch.randn((R, 3), generator=gen),
            5.0 * torch.randn((N, 3), generator=gen))


@pytest.mark.parametrize('k', [2, 8, 16])
def test_plain_result_passes(k):
    ref, nbr = _clouds()
    d2, idx = knn._nnk_torch(ref, nbr, k)
    got = nnk_tolerance_failures(ref, nbr, d2, idx, idx)
    assert got['differ'] == got['index_failures'] == 0
    assert got['repeat_failures'] == got['d2_failures'] == 0
    assert got['max_d2_err'] <= 1e-4


def test_exact_duplicates_lower_index_first_and_a_swap_is_a_tie():
    """Every neighbour twice (row j + 300 duplicates row j), k = 2: the
    plain version returns the pair (j, j + 300) in that order; the swapped
    pair passes as a tie, a pair of two copies of one index does not."""
    ref, base = _clouds()
    nbr = torch.cat([base, base])
    d2, idx = knn._nnk_torch(ref, nbr, 2)
    assert bool((idx[:, 1] == idx[:, 0] + 300).all())
    got = nnk_tolerance_failures(ref, nbr, d2, idx.flip(-1), idx)
    assert got['differ'] == len(ref)
    assert got['index_failures'] == got['repeat_failures'] == 0
    assert got['d2_failures'] == 0
    same = idx[:, :1].expand(-1, 2)
    got = nnk_tolerance_failures(ref, nbr, d2, same, idx)
    assert got['repeat_failures'] == len(ref)


@pytest.mark.parametrize('gap,fails', [(2e-7, False), (1e-2, True)])
def test_near_tie_at_the_kth_position(gap, fails):
    """Row 0 has neighbours at squared distances 1, 4 and 4 + gap (k = 2):
    taking the third for the second is a near-tie for a gap of 2e-7
    (inside 1e-6 (|a|^2 + |b|^2) + 1e-6) and a miss for 1e-2."""
    ref = torch.tensor([[0.0, 0.0, 0.0]], dtype=torch.float64)
    nbr = torch.tensor([[1.0, 0.0, 0.0], [0.0, 2.0, 0.0],
                        [0.0, 0.0, (4.0 + gap) ** 0.5]], dtype=torch.float64)
    idx_plain = torch.tensor([[0, 1]])
    idx = torch.tensor([[0, 2]])
    got = nnk_tolerance_failures(ref, nbr, torch.tensor([[1.0, 4.0 + gap]]),
                                 idx, idx_plain)
    assert got['differ'] == 1
    assert got['index_failures'] == int(fails)
    assert got['repeat_failures'] == got['d2_failures'] == 0


def test_distance_off_its_pair_fails():
    ref, nbr = _clouds(1)
    d2, idx = knn._nnk_torch(ref, nbr, 4)
    d2 = d2.clone()
    d2[3, 2] += 1e-3 * (1 + float((ref[3] ** 2).sum()
                                  + (nbr[idx[3, 2]] ** 2).sum()))
    got = nnk_tolerance_failures(ref, nbr, d2, idx, idx)
    assert got['index_failures'] == 0 and got['d2_failures'] == 1
