"""The rule that holds the ``nn1`` kernel to its plain version
(``pypose_tpu_torch.testing.nn1_tolerance_failures``), on built cases: an
exact duplicate neighbour, where the plain version takes the lower index
and the higher one passes as a tie; a near-tie inside the tolerance; a
clear miss outside it, which fails; and a distance off its pair.  The
plain version itself is held against the JAX package in
``test_torch_knn.py``.
"""

import pytest
import torch

from pypose_tpu_torch.ops import knn
from pypose_tpu_torch.testing import nn1_tolerance_failures


def _clouds(seed=0, R=64, N=300):
    gen = torch.Generator().manual_seed(seed)
    return (5.0 * torch.randn((R, 3), generator=gen),
            5.0 * torch.randn((N, 3), generator=gen))


def test_plain_result_passes():
    ref, nbr = _clouds()
    d2, idx = knn._nn1_torch(ref, nbr)
    got = nn1_tolerance_failures(ref, nbr, d2, idx, idx)
    assert got['differ'] == got['index_failures'] == got['d2_failures'] == 0
    assert got['max_d2_err'] <= 1e-4


def test_exact_duplicate_lower_index_wins_and_higher_is_a_tie():
    ref, base = _clouds()
    nbr = torch.cat([base, base])      # row j + 300 duplicates row j
    d2, idx = knn._nn1_torch(ref, nbr)
    assert bool((idx < 300).all())     # the plain version: the lower index
    got = nn1_tolerance_failures(ref, nbr, d2, idx + 300, idx)
    assert got['differ'] == len(ref)
    assert got['index_failures'] == got['d2_failures'] == 0


@pytest.mark.parametrize('gap,fails', [(2e-7, False), (1e-2, True)])
def test_near_tie_inside_and_clear_miss_outside(gap, fails):
    """Row 0 has two neighbours at squared distances 1 and 1 + gap: a gap
    of 2e-7 is inside 1e-6 (|a|^2 + |b|^2) + 1e-6, one of 1e-2 is not."""
    ref = torch.tensor([[0.0, 0.0, 0.0]], dtype=torch.float64)
    nbr = torch.tensor([[1.0, 0.0, 0.0], [(1.0 + gap) ** 0.5, 0.0, 0.0]],
                       dtype=torch.float64)
    idx_plain = torch.tensor([0])
    idx = torch.tensor([1])
    got = nn1_tolerance_failures(ref, nbr, torch.tensor([1.0 + gap]), idx,
                                 idx_plain)
    assert got['differ'] == 1
    assert got['index_failures'] == int(fails)
    assert got['d2_failures'] == 0


def test_distance_off_its_pair_fails():
    ref, nbr = _clouds(1)
    d2, idx = knn._nn1_torch(ref, nbr)
    d2 = d2.clone()
    d2[3] += 1e-3 * (1 + float((ref[3] ** 2).sum() + (nbr[idx[3]] ** 2).sum()))
    got = nn1_tolerance_failures(ref, nbr, d2, idx, idx)
    assert got['index_failures'] == 0 and got['d2_failures'] == 1
