r"""Where the card waits in a ``SparseLM`` solve: one solve traced by
``torch.profiler`` with host and device activity, its device operations'
idle gaps and launches put under the ``sparselm.*`` spans that
``optim/sparse.py`` opens while a profiler runs.

For each span name: ``n`` (ranges), ``host_s`` (their host time),
``self_s`` (host time not under a child ``sparselm.*`` range), ``ops`` and
``device_s`` (the device operations whose launching host operation lies
innermost in that span, and their device time), ``d2h`` (of those, the
device-to-host copies) and ``idle_s`` (every idle gap of the device, each
given whole to the innermost span at its middle); besides, the idle time
under no span, the steps, damping tries and CG solves of the traced solve,
and the rise of ``sparse.HOST_READS`` over it.

The cases are the benchmark's three pose-graph solves, built through the
port's own API (``bench.py``'s graphs): ``sphere2500.se3``
(``data/synthetic_sphere2500_seed42.g2o``, 6 LM steps at CG 150 then 6 at
1200, tol 1e-9), ``sphere100k.se3`` (``synthetic_sphere(100000)`` at seed
42, 6 steps at CG 250, tol 1e-3) and ``sphere2500.sim3`` (the g2o graph
lifted to Sim3 with scale seed 7, 6 steps at CG 150, tol 1e-8), each
TrustRegion(1e4) with node 0 fixed.  Run from the repository root on a
machine with the GPU:

    python3 -m pypose_tpu_torch.probes.lm_probes [--cases NAME ...] \
        [--repeats 3]

Prints one JSON line a traced solve: ``repeats`` with the spans on, each
after one with them off (the cost of the spans when traced), and the
median of ``repeats`` untraced solves before them.  ``d2h_by_op`` names
the torch operation and span that launched each device-to-host copy.
"""

import argparse
import bisect
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

PREFIX = 'sparselm.'
ROOT = Path(__file__).resolve().parents[2]
G2O = ROOT / 'data' / 'synthetic_sphere2500_seed42.g2o'

# (group, graph, phases (cg_iter, cg_tol, steps, decreasing, patience))
CASES = {
    'sphere2500.se3': ('SE3', 'g2o', [(150, 1e-9, 6, 1e-6, 2),
                                      (1200, 1e-9, 6, 1e-7, 2)]),
    'sphere100k.se3': ('SE3', 'sphere100k', [(250, 1e-3, 6, 1e-6, 2)]),
    'sphere2500.sim3': ('Sim3', 'g2o', [(150, 1e-8, 6, 1e-6, 2)]),
}


def _segments(ranges):
    """(bounds, owner): over [bounds[k], bounds[k + 1]) the innermost of
    the properly nested ``ranges`` [(name, start, end)] is
    ``ranges[owner[k]]``, or none where ``owner[k]`` is -1."""
    order = sorted(range(len(ranges)),
                   key=lambda i: (ranges[i][1], -ranges[i][2]))
    bounds, owner, stack = [], [], []

    def mark(t):
        bounds.append(t)
        owner.append(stack[-1] if stack else -1)
    for i in order:
        while stack and ranges[stack[-1]][2] <= ranges[i][1]:
            mark(ranges[stack.pop()][2])
        stack.append(i)
        mark(ranges[i][1])
    while stack:
        mark(ranges[stack.pop()][2])
    return bounds, owner


def attribute(ranges, ops, gaps):
    """Put host time, device operations and idle gaps under spans.

    ``ranges``: [(name, start, end)] host ranges of one thread, properly
    nested; ``ops``: [(launch, device, d2h)], each device operation's
    launch time on the host, its device time and whether it is a
    device-to-host copy; ``gaps``: [(start, end)] the device's idle gaps.
    All times on one clock, in one unit.

    Returns ({name: {'n', 'host_s', 'self_s', 'ops', 'device_s', 'd2h',
    'idle_s'}}, idle under no range): an op or a gap goes to the innermost
    range holding its launch or its middle; ``self_s`` is the part of a
    range's time that no range nested in it covers.
    """
    bounds, owner = _segments(ranges)
    out = {}
    for name, s, e in ranges:
        row = out.setdefault(name, {'n': 0, 'host_s': 0, 'self_s': 0,
                                    'ops': 0, 'device_s': 0, 'd2h': 0,
                                    'idle_s': 0})
        row['n'] += 1
        row['host_s'] += e - s
    for k in range(len(bounds) - 1):
        if owner[k] >= 0:
            out[ranges[owner[k]][0]]['self_s'] += bounds[k + 1] - bounds[k]

    def at(t):
        k = bisect.bisect_right(bounds, t) - 1
        return owner[k] if k >= 0 else -1
    for launch, dev, d2h in ops:
        i = at(launch)
        if i >= 0:
            row = out[ranges[i][0]]
            row['ops'] += 1
            row['device_s'] += dev
            row['d2h'] += bool(d2h)
    unattributed = 0
    for g0, g1 in gaps:
        i = at((g0 + g1) / 2)
        if i >= 0:
            out[ranges[i][0]]['idle_s'] += g1 - g0
        else:
            unattributed += g1 - g0
    return out, unattributed


def idle_gaps(intervals):
    """The gaps between the pieces of the union of (start, end)
    intervals, and the union's length."""
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return gaps, busy


def trace_breakdown(prof):
    """:func:`attribute` over a ``torch.profiler.profile``'s raw kineto
    events, in seconds: (spans, unattributed idle, summary).  The device's
    operations are its kernels, copies and sets, not the profiler's
    device-side copies of host annotations, each launched where the host
    event its correlation ids name started; ``summary`` holds the idle
    and busy totals and the device-side events named like a span (with
    whether torch flags them as annotations)."""
    from torch.autograd import DeviceType
    events = list(prof.profiler.kineto_results.events())
    cuda = [e for e in events if e.device_type() == DeviceType.CUDA]
    dev = [e for e in cuda if not e.name().startswith('aten::')
           and not e.is_user_annotation()
           and not e.name().startswith(PREFIX)]
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    # the launch as portbench/tracing.py:reduce finds it
    by_corr = {}
    for e in host:
        if e.correlation_id() > 0:
            by_corr.setdefault(e.correlation_id(), e)
    ops = []
    for d in dev:
        launch = by_corr.get(d.linked_correlation_id()) \
            or by_corr.get(d.correlation_id())
        if launch is not None:
            ops.append((launch.start_ns(), d.duration_ns(),
                        'DtoH' in d.name()))
    ranges = [(e.name(), e.start_ns(), e.end_ns()) for e in host
              if e.name().startswith(PREFIX)]
    gaps, busy = idle_gaps([(d.start_ns(), d.start_ns() + d.duration_ns())
                            for d in dev])
    spans, unattributed = attribute(ranges, ops, gaps)
    for row in spans.values():
        for k in ('host_s', 'self_s', 'device_s', 'idle_s'):
            row[k] /= 1e9
    annotations = {}
    for e in cuda:
        if e.name().startswith(PREFIX):
            key = f'{e.name()} annotation={e.is_user_annotation()}'
            annotations[key] = annotations.get(key, 0) + 1
    summary = {'idle_s': sum(g1 - g0 for g0, g1 in gaps) / 1e9,
               'busy_s': busy / 1e9, 'device_ops': len(dev),
               'launched_ops': len(ops),
               'd2h': sum(d2h for _, _, d2h in ops),
               'd2h_by_op': _d2h_by_op(ranges, host, [
                   t for t, _, d2h in ops if d2h]),
               'device_side_spans': annotations}
    return spans, unattributed / 1e9, summary


def _d2h_by_op(ranges, host, launches):
    """{'<innermost span> <outermost aten op>': device-to-host copies}:
    which torch operation under which span launched each copy."""
    bounds, owner = _segments(ranges)
    aten = [e for e in host if e.name().startswith('aten::')]
    s = np.array([e.start_ns() for e in aten], dtype=np.int64)
    e = np.array([e.end_ns() for e in aten], dtype=np.int64)
    out = {}
    for t in launches:
        k = bisect.bisect_right(bounds, t) - 1
        span = ranges[owner[k]][0] if k >= 0 and owner[k] >= 0 else '-'
        holding = np.nonzero((s <= t) & (e >= t))[0]
        op = aten[holding[np.argmax((e - s)[holding])]].name() \
            if len(holding) else '-'
        out[f'{span} {op}'] = out.get(f'{span} {op}', 0) + 1
    return out


def build(name, device='cuda'):
    """(optimizer, phases) of the case ``name`` (:data:`CASES`)."""
    from .. import datasets
    from ..testing import pgo_group_instance, pgo_optimizer
    group, graph, phases = CASES[name]
    if graph == 'g2o':
        ds = datasets.load_g2o(str(G2O), device=device)
    else:
        ds = datasets.synthetic_sphere(100_000, seed=42, device=device)
    if group != 'SE3':
        ds = pgo_group_instance(ds, group, torch.Generator().manual_seed(7))
    it, tol = phases[0][:2]
    return pgo_optimizer(ds, radius=1e4, cg_iter=it, cg_tol=tol), phases


def solve(opt, start, phases):
    """The case's whole schedule from ``start``: (chi2 history, CG
    iterations a step), both over every phase."""
    opt.params = {'poses': start}
    opt.strategy_state = None
    hist, its = [], []
    for cg_iter, cg_tol, steps, decreasing, patience in phases:
        opt.cg_iter, opt.cg_tol = cg_iter, cg_tol
        opt.optimize(steps=steps, patience=patience, decreasing=decreasing)
        hist += opt.history
        its += opt.cg_iterations
    torch.cuda.synchronize()
    return hist, its


def run(name, repeats):
    """The case's untraced solves, then ``repeats`` traced solves with the
    spans on, each after one traced with them off (``_span`` patched to
    the no-op): what the spans cost a traced solve."""
    from torch.profiler import ProfilerActivity, profile
    from ..optim import sparse
    opt, phases = build(name)
    start = opt.params['poses']
    solve(opt, start, phases)                    # warm-up
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        solve(opt, start, phases)
        walls.append(time.perf_counter() - t0)
    span = sparse._span
    for k in range(2 * repeats):
        spans_on = k % 2 == 1
        sparse._span = span if spans_on else lambda name: sparse._NO_SPAN
        reads = sparse.HOST_READS
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                hist, its = solve(opt, start, phases)
                wall = time.perf_counter() - t0
        finally:
            sparse._span = span
        reads = sparse.HOST_READS - reads
        spans, unattributed, summary = trace_breakdown(prof)
        steps, tries = len(hist), sum(len(s) for s in its)
        print(json.dumps({
            'case': name, 'card': torch.cuda.get_device_name(0),
            'spans_on': spans_on,
            'untraced_wall_s_median': statistics.median(walls),
            'traced_wall_s': wall, 'steps': steps, 'tries': tries,
            'cg_iterations': sum(map(sum, its)), 'host_reads': reads,
            'host_reads_per_step': reads / steps,
            'unattributed_idle_s': unattributed, **summary,
            'spans': spans}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--cases', nargs='*', default=list(CASES))
    ap.add_argument('--repeats', type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in args.cases:
        run(name, args.repeats)
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
