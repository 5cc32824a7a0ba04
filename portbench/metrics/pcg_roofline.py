"""The PCG solves' least time over the device time of everything the
program's stencil-solve entry (ops/stencil_cg.py:stencil_cg, inside the
benchmark's span) launched, in the traced stretch, in %.  The least time
is roofline/stencil_pcg.py's count of the work from N, t, the offsets and
the iterations each solve ran, at the card's published peaks (the run
records the card's power limit beside it)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    'portbench_roofline_stencil_pcg',
    Path(__file__).resolve().parent.parent / 'roofline' / 'stencil_pcg.py')
_work = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_work)


def read(run):
    st = run.stretch
    if st is None or run.peaks is None or st['span_device_s'] <= 0:
        return None
    least = sum(_work.least_seconds(run.N, run.t, run.n_off, i, run.peaks)
                for s in st['solves'] for p in s.its for step in p
                for i in step)
    return 100.0 * least / st['span_device_s']
