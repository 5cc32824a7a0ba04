"""The port's examples imu_integration, rotation_averaging,
bundle_adjustment, mini_slam, mpc_cartpole run on the CPU at the tiny
sizes of tests/test_examples_smoke.py (``_examples.ARGS``), one
subprocess each, with their own assertions; one of three files, so that
``--dist loadfile`` spreads the examples over the workers."""

from _examples import run_example
from pypose_tpu_torch.testing import cap_threads

cap_threads()


def test_imu_integration_runs():
    run_example('imu_integration')


def test_rotation_averaging_runs():
    out = run_example('rotation_averaging')
    assert '[sim3-pgo]' in out


def test_bundle_adjustment_runs():
    run_example('bundle_adjustment')


def test_mini_slam_runs():
    out = run_example('mini_slam')
    assert 'BA    APE RMSE' in out


def test_mpc_cartpole_runs():
    run_example('mpc_cartpole')
