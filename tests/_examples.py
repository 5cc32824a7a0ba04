"""Runs one of the port's examples (``pypose_tpu_torch/examples/``) on the
CPU in a subprocess, at the tiny sizes of tests/test_examples_smoke.py,
for tests/test_torch_examples_{a,b,c}.py."""

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX smoke test's flags; mpc_linear_learning at 20 iterations, not 5:
# its held-out loss falls to 0.44-0.71 of its start within 5 updates over
# generator seeds 0-3, to 0.20-0.39 within 20, and the example asserts 0.5
ARGS = {
    'splines': ['--interval', '0.5'],
    'dynamics': ['--steps', '20'],
    'filters': ['--steps', '20', '--particles', '100'],
    'icp_align': ['--points', '100'],
    'pgo': ['--poses', '100', '--steps', '3'],
    'imu_integration': ['--frames', '50'],
    'rotation_averaging': ['--nodes', '40', '--steps', '5'],
    'bundle_adjustment': ['--cams', '6', '--points', '80', '--steps', '4'],
    'mini_slam': ['--frames', '5', '--points', '40'],
    'mpc_cartpole': ['--horizon', '8', '--iters', '2'],
    'reproj_pgo': ['--poses', '8', '--landmarks', '30', '--steps', '3'],
    'imu_corrector': ['--iters', '10', '--frames', '20'],
    'bicycle': ['--steps', '10', '--particles', '100'],
    'mpc_linear_learning': ['--iters', '20'],
    'pointcloud_registration': ['--points', '200'],
}


def run_example(name):
    """The example's stdout; asserts exit code 0 and some output."""
    env = dict(os.environ, OMP_NUM_THREADS=str(torch.get_num_threads()))
    proc = subprocess.run(
        [sys.executable, '-m', f'pypose_tpu_torch.examples.{name}',
         '--device', 'cpu'] + ARGS[name],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    assert proc.returncode == 0, (
        f'{name} failed\nstdout:\n{proc.stdout[-2000:]}\n'
        f'stderr:\n{proc.stderr[-2000:]}')
    assert proc.stdout.strip(), f'{name} printed nothing'
    return proc.stdout
