"""Readings of a torch.profiler trace, taken from its raw kineto events
(as ``chip_smoke.py:device_totals`` takes its device operations;
``key_averages`` is ~45 times slower on large traces).  :func:`reduce`
reads one profiled stretch: the device's busy time (the union of its
operations' intervals), the device operations launched inside the benchmark's own
``record_function`` span (:data:`PCG_SPAN`), and the idle gaps between
device operations, each labelled by the innermost host operation running
at the gap's middle.
"""

import numpy as np

# the span the benchmark puts around the program's call into
# ops/stencil_cg.py (harness.pcg_span)
PCG_SPAN = 'portbench.pcg'
# the gaps labelled for the breakdown: the longest ones
LABELLED_GAPS = 200


def _device_events(events):
    """The operations on the card: kernels, copies, sets; not the
    profiler's device-side copies of host annotations."""
    from torch.autograd import DeviceType
    return [e for e in events if e.device_type() == DeviceType.CUDA
            and not e.name().startswith('aten::')
            and not e.is_user_annotation() and e.name() != PCG_SPAN]


def _union_ns(intervals):
    """Total length of the union of (start, end) intervals, and the gaps
    between its pieces as (start, end)."""
    total, gaps = 0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def reduce(prof, wall_s):
    """The readings of one profiled stretch of ``wall_s`` seconds:
    ``busy_s`` (device busy, the union of its operations), ``device_ops``,
    ``span_device_s`` and ``span_ops`` (the device operations whose
    launching host operation started inside a :data:`PCG_SPAN` range),
    ``device_top`` [(name, s)] and ``idle_top`` [(host label, s)]; None
    where the trace holds no device operation."""
    from torch.autograd import DeviceType
    events = list(prof.profiler.kineto_results.events())
    dev = _device_events(events)
    if not dev:
        return None
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    by_corr = {}
    for e in host:
        if e.correlation_id() > 0:
            by_corr.setdefault(e.correlation_id(), e)
    spans = sorted((e.start_ns(), e.end_ns()) for e in host
                   if e.name() == PCG_SPAN)
    starts = np.array([s for s, _ in spans], dtype=np.int64)
    ends = np.array([e for _, e in spans], dtype=np.int64)

    def in_span(d):
        launch = by_corr.get(d.linked_correlation_id()) \
            or by_corr.get(d.correlation_id())
        if launch is None or not len(starts):
            return False
        k = np.searchsorted(starts, launch.start_ns(), side='right') - 1
        return k >= 0 and launch.start_ns() <= ends[k]

    span_ns = span_ops = 0
    by_name = {}
    for d in dev:
        by_name[d.name()] = by_name.get(d.name(), 0) + d.duration_ns()
        if in_span(d):
            span_ns += d.duration_ns()
            span_ops += 1
    busy_ns, gaps = _union_ns([(d.start_ns(), d.start_ns() + d.duration_ns())
                               for d in dev])
    return {'wall_s': wall_s, 'busy_s': busy_ns / 1e9,
            'device_ops': len(dev), 'span_device_s': span_ns / 1e9,
            'span_ops': span_ops, 'spans': len(spans),
            'device_top': sorted(((n[:120], ns / 1e9)
                                  for n, ns in by_name.items()),
                                 key=lambda x: -x[1])[:10],
            'idle_top': _label_gaps(gaps, host)}


def _label_gaps(gaps, host):
    """The longest idle gaps summed by what the host was doing at their
    middle: the innermost host operation running then, or 'host code
    between torch operations' where none was."""
    if not gaps or not host:
        return []
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:LABELLED_GAPS]
    s = np.array([e.start_ns() for e in host], dtype=np.int64)
    e = np.array([e.end_ns() for e in host], dtype=np.int64)
    names = [h.name() for h in host]
    out = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        inside = np.nonzero((s <= mid) & (e >= mid))[0]
        label = names[inside[np.argmin((e - s)[inside])]][:120] \
            if len(inside) else 'host code between torch operations'
        out[label] = out.get(label, 0) + (g1 - g0)
    return sorted(((k, v / 1e9) for k, v in out.items()),
                  key=lambda x: -x[1])[:10]
