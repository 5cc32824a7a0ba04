"""SparseLM's spans and host-read counter on the CPU (the class docstring's
30-pose odometry ring, 'stencil' route), and the span attribution of
``probes/lm_probes.py`` on hand-built intervals.

Profiler off: no ``record_function`` is entered.  Profiler on: a
``sparselm.step`` range an LM step, a ``sparselm.try`` and a
``sparselm.pcg`` range a CG solve, formation, normal equations and tries
inside a step, and a ``sparselm.host_read`` range for each read counted in
``sparse.HOST_READS``: a ``.tolist()`` a step, a ``bool(rejectable)`` and
an ``int(i)`` a damping try on this problem.  The results are the same
bits either way.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pypose_tpu_torch.lietensor.utils import se3
from pypose_tpu_torch.optim import sparse
from pypose_tpu_torch.optim.sparse import SparseLM, pgo_factor
from pypose_tpu_torch.optim.strategy import TrustRegion
from pypose_tpu_torch.probes.lm_probes import attribute, idle_gaps


def _ring():
    g = torch.Generator().manual_seed(0)
    N = 30
    truth = se3(0.3 * torch.randn(N, 6, generator=g)).Exp()
    i = torch.arange(N)
    edges = torch.stack([i, (i + 1) % N], 1)
    Z = truth[edges[:, 0]].Inv() @ truth[edges[:, 1]]
    noisy = se3(0.1 * torch.randn(N, 6, generator=g)).Exp() @ truth
    fixed = torch.zeros(N, dtype=torch.bool)
    fixed[0] = True
    return SparseLM({'poses': noisy}, [pgo_factor(edges, Z)],
                    strategy=TrustRegion(radius=1e4), fixed={'poses': fixed})


def _optimize(opt):
    return opt.optimize(steps=10, decreasing=1e-9, patience=2)


def _ranges(prof):
    """{span name: [(start, end)]} of the trace's sparselm.* host ranges."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith('sparselm.'):
            out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return out


def _traced(run):
    """(result of ``run()``, its sparselm.* ranges, HOST_READS's rise)."""
    reads = sparse.HOST_READS
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    return out, _ranges(prof), sparse.HOST_READS - reads


def test_span_is_a_shared_no_op_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError('record_function entered with no profiler')
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    assert not torch.autograd._profiler_enabled()
    assert sparse._span('sparselm.step') is sparse._span('sparselm.try')
    opt = _ring()
    assert _optimize(opt) < 1e-8
    opt.step()


def test_spans_and_host_reads_of_optimize():
    opt = _ring()
    _, ranges, reads = _traced(lambda: _optimize(opt))
    steps = len(opt.history)
    solves = sum(len(s) for s in opt.cg_iterations)
    assert steps >= 3
    assert len(ranges['sparselm.optimize']) == 1
    assert len(ranges['sparselm.step']) == steps
    assert len(ranges['sparselm.try']) == solves
    assert len(ranges['sparselm.pcg']) == solves
    assert len(ranges['sparselm.precond']) == solves
    assert len(ranges['sparselm.evaluate']) == solves
    assert len(ranges['sparselm.formation']) == steps
    assert len(ranges['sparselm.normal_eq']) == steps
    for name in ('sparselm.formation', 'sparselm.normal_eq', 'sparselm.try'):
        for s, e in ranges[name]:
            assert any(s0 <= s and e <= e0
                       for s0, e0 in ranges['sparselm.step']), name
    for name in ('sparselm.pcg', 'sparselm.precond', 'sparselm.evaluate'):
        for s, e in ranges[name]:
            assert any(s0 <= s and e <= e0
                       for s0, e0 in ranges['sparselm.try']), name
    assert reads == steps + 2 * solves
    assert len(ranges['sparselm.host_read']) == reads


def test_spans_and_host_reads_of_step():
    opt = _ring()
    _, ranges, reads = _traced(opt.step)
    solves = len(opt.cg_iterations[0])
    assert len(ranges['sparselm.optimize']) == 1
    assert len(ranges['sparselm.step']) == 1
    assert len(ranges['sparselm.try']) == solves
    assert reads == 1 + 2 * solves == len(ranges['sparselm.host_read'])


def test_iteration_counts_read_only_tensors():
    reads = sparse.HOST_READS
    assert sparse._iterations([torch.tensor(7, dtype=torch.int32), 5]) == \
        [7, 5]
    assert sparse.HOST_READS - reads == 1


@pytest.mark.parametrize('entry', ['optimize', 'step'])
def test_results_are_bit_equal_with_the_profiler_on(entry):
    def run():
        opt = _ring()
        if entry == 'optimize':
            _optimize(opt)
        else:
            opt.step()
            opt.step()
        return opt.history, opt.loss, opt.cg_iterations, \
            opt.params['poses'].tensor()
    off = run()
    on, _, _ = _traced(run)
    assert off[:3] == on[:3]
    assert torch.equal(off[3], on[3])


# the span attribution on hand-built intervals: a step (0, 100) holding
# formation (10, 40) and a try (50, 90) that holds a pcg range (60, 80)
RANGES = [('step', 0, 100), ('formation', 10, 40), ('try', 50, 90),
          ('pcg', 60, 80), ('step', 200, 210)]


def test_attribute_self_time_and_innermost_launches():
    ops = [(5, 2, False), (15, 3, False), (39, 1, True), (55, 4, False),
           (70, 8, False), (85, 1, True), (150, 9, False)]
    spans, _ = attribute(RANGES, ops, [])
    assert spans['step'] == {'n': 2, 'host_s': 110, 'self_s': 30 + 10,
                             'ops': 1, 'device_s': 2, 'd2h': 0, 'idle_s': 0}
    assert spans['formation']['self_s'] == 30
    assert spans['try']['self_s'] == 20 and spans['pcg']['self_s'] == 20
    assert (spans['formation']['ops'], spans['formation']['device_s'],
            spans['formation']['d2h']) == (2, 4, 1)
    assert (spans['try']['ops'], spans['try']['d2h']) == (2, 1)
    assert (spans['pcg']['ops'], spans['pcg']['device_s']) == (1, 8)


def test_attribute_gaps_whole_to_the_innermost_range_at_their_middle():
    # middles 20 (formation), 45 (step), 69 (pcg), 150 (none), 205 (step)
    gaps = [(18, 22), (42, 48), (58, 80), (120, 180), (201, 209)]
    spans, unattributed = attribute(RANGES, [], gaps)
    assert spans['formation']['idle_s'] == 4
    assert spans['step']['idle_s'] == 6 + 8
    assert spans['pcg']['idle_s'] == 22
    assert spans['try']['idle_s'] == 0
    assert unattributed == 60
    assert sum(r['idle_s'] for r in spans.values()) + unattributed == \
        sum(e - s for s, e in gaps)


def test_attribute_without_ranges_leaves_every_gap_unattributed():
    spans, unattributed = attribute([], [(1, 1, False)], [(0, 5), (7, 9)])
    assert spans == {} and unattributed == 7


def test_idle_gaps_between_the_union_of_device_intervals():
    gaps, busy = idle_gaps([(0, 10), (5, 12), (20, 25), (25, 30), (40, 41)])
    assert gaps == [(12, 20), (30, 40)]
    assert busy == 12 + 10 + 1
