"""The tiled matvec's ring plan (``ops.stencil_cg.tiled_plan``) on the
CPU.

``csrc/stencil_cg_tiled.cu`` computes the same plan (the card tests hold
the two equal through ``ppt_tiled_plan``, and the ring kernel itself bit
for bit to the one-thread-a-node kernels); here it is held to its
budgets: shared memory within ``SMEM_PER_BLOCK`` for t = 1..32 and 1..16
offsets, tiles that cover N exactly, stages of whole 16-byte units."""

import numpy as np
import pytest

from pypose_tpu_torch.ops import stencil_cg as scg
from pypose_tpu_torch.testing import cap_threads

cap_threads()


@pytest.mark.parametrize('t', range(1, 33))
def test_plan_fits_shared_memory(t):
    """For every offset count 1..16 and N of each residue mod 4: the ring
    and its mbarriers within SMEM_PER_BLOCK; at least four stages; a
    stage's rows hold every column and block row of a part between them,
    at most 96 rows a stage (three a producer lane); the block rows split
    into as few groups of at most 8 as they need, evenly."""
    groups = -(-t // 8)
    for n_off in range(1, scg.MAX_OFFSETS + 1):
        for N in (100_000, 100_001, 100_002, 100_003, 53):
            p = scg.tiled_plan(N, t, n_off, 132)
            assert p['smem'] <= scg.SMEM_PER_BLOCK
            assert p['stages'] >= 4
            assert p['parts'] == 1 + 2 * n_off
            assert 1 <= p['group'] <= t and 1 <= p['slab'] <= t
            assert p['rows_per_stage'] == p['slab'] * (1 + p['group'])
            assert p['rows_per_stage'] <= 96
            assert p['group'] == -(-t // groups)


@pytest.mark.parametrize('N', [1, 2, 3, 4, 5, 40, 53, 127, 128, 129, 255,
                               256, 2500, 99_999, 100_000, 100_003,
                               10 ** 6 - 1, 10 ** 6])
def test_plan_tiles_cover_n(N):
    """The tiles of every CTA cover nodes 0..N-1 exactly once, each of 1
    to tile_nodes nodes, on cards of 132 and 114 SMs, with at most one CTA
    a 128 nodes and one an SM."""
    for sms in (132, 114):
        p = scg.tiled_plan(N, 3, 2, sms=sms)
        assert p['ctas'] == min(-(-N // 128), sms)
        tiles = scg.tiled_tiles(N, p['ctas'])
        assert len(tiles) == p['tiles']
        covered = np.zeros(N, dtype=np.int64)
        for n0, length in tiles:
            assert 1 <= length <= p['tile_nodes']
            covered[n0:n0 + length] += 1
        assert (covered == 1).all()


@pytest.mark.parametrize('t', range(1, 33))
def test_plan_stages_are_whole_16_byte_units(t):
    """Every stage, its vector region and its pitches keep 16-byte units
    where a bulk copy needs them: stage bytes % 16 == 0, the row pitch at
    N's residue mod 4, the block pitches at t N's, each wide enough for
    its rows."""
    for N in (100_000, 100_001, 100_002, 100_003):
        p = scg.tiled_plan(N, t, 16, 132)
        assert p['stage_bytes'] % 16 == 0
        assert (p['smem'] - 256) % 16 == 0
        assert p['row_pitch'] % 4 == N % 4
        assert p['row_pitch'] >= p['tile_nodes'] + 18
        assert p['forward_pitch'] % 4 == (t * N) % 4
        assert p['back_pitch'] % 4 == (t * N) % 4
        assert p['forward_pitch'] >= p['slab'] * p['row_pitch']
        assert p['back_pitch'] >= p['group'] * p['row_pitch']


def test_plan_refuses_what_the_kernels_refuse():
    for args in ((0, 3, 2), (10, 0, 2), (10, 3, 17), (10, 3, -1)):
        with pytest.raises(ValueError):
            scg.tiled_plan(*args, 132)
