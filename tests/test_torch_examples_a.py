"""The port's examples splines, dynamics, filters, icp_align, pgo run on
the CPU at the tiny sizes of tests/test_examples_smoke.py
(``_examples.ARGS``), one subprocess each, with their own assertions;
one of three files, so that ``--dist loadfile`` spreads the examples
over the workers."""

from _examples import run_example
from pypose_tpu_torch.testing import cap_threads

cap_threads()


def test_splines_runs():
    out = run_example('splines')
    assert 'chspline: (6, 3) -> (11, 3)' in out


def test_dynamics_runs():
    run_example('dynamics')


def test_filters_runs():
    out = run_example('filters')
    assert out.count('RMSE') == 3


def test_icp_align_runs():
    run_example('icp_align')


def test_pgo_runs():
    out = run_example('pgo')
    assert "pgo: route 'stencil'" in out
    assert 'APE RMSE vs ground truth (aligned)' in out
