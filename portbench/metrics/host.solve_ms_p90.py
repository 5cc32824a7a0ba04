"""The 90th percentile (nearest rank) of the wall time of every solve in
the traced run's window (untraced), in ms (host clock, each solve ending
synchronised).  A per-layer metric: the shared host's run-to-run spread
would need a bound past the largest allowed, 0.25 (PERF.md section 2)."""

import math


def read(run):
    v = sorted(s.wall_s for s in run.solves)
    return 1e3 * v[max(0, math.ceil(0.9 * len(v)) - 1)]
