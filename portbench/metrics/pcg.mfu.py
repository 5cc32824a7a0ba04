"""The PCG layer's useful work over the window at the card's float32 peak,
in %: every solve of the window counted at one fixed amount of PCG work,
the iterations the float64 reference's solve of the same graph ran
(roofline/stencil_pcg.py's count, whatever kernel runs it), over the
window's seconds on the host clock.  Fixed a solve, so iterations the
program adds or wastes do not raise it; formation's work is not counted,
so it bounds the whole solve's share from below."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    'portbench_roofline_stencil_pcg',
    Path(__file__).resolve().parent.parent / 'roofline' / 'stencil_pcg.py')
_work = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_work)


def read(run):
    if run.peaks is None or run.ref_its is None:
        return None
    per_solve = sum(_work.work(run.N, run.t, run.n_off, i)[0]
                    for p in run.ref_its for step in p for i in step)
    return 100.0 * len(run.solves) * per_solve / run.window_s \
        / run.peaks['fp32_flop_per_s']
