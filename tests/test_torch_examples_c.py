"""The port's examples reproj_pgo, imu_corrector, bicycle,
mpc_linear_learning, pointcloud_registration run on the CPU at the tiny
sizes of tests/test_examples_smoke.py (``_examples.ARGS``), one
subprocess each, with their own assertions; one of three files, so that
``--dist loadfile`` spreads the examples over the workers."""

from _examples import run_example
from pypose_tpu_torch.testing import cap_threads

cap_threads()


def test_reproj_pgo_runs():
    run_example('reproj_pgo')


def test_imu_corrector_runs():
    run_example('imu_corrector')


def test_bicycle_runs():
    out = run_example('bicycle')
    assert out.count('RMSE') == 3


def test_mpc_linear_learning_runs():
    out = run_example('mpc_linear_learning')
    assert 'loss ' in out.splitlines()[-1]


def test_pointcloud_registration_runs():
    run_example('pointcloud_registration')
