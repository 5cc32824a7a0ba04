"""Shared set-up of the benchmark's own tests: the benchmark's folder and
the repository root on ``sys.path``, and a tiny cell in a temporary copy
of the benchmark for the CPU's dry path."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
for p in (str(REPO), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# a 60-pose sphere with short phases: small enough for the CPU, the same
# code path as the cells
TINY_CONFIG = {
    'name': 'tiny',
    'graph': {'kind': 'sphere', 'n_poses': 60, 'radius': 25.0,
              'loops_per_pose': 0.8, 'meas_sigma': [0.05, 0.02],
              'init_sigma': [1.0, 0.3]},
    'dtype': 'float32', 'tf32': False,
    'pcg_counter': {'SE3': 'LAUNCHES', 'Sim3': 'LAUNCHES'}}
TINY_TRAFFIC = {
    'entry': 'SparseLM.optimize', 'clients': 1, 'group': 'SE3',
    'radius': 1e4, 'judged_solves': 2,
    'phases': [{'cg_iter': 60, 'cg_tol': 1e-9, 'steps': 4,
                'decreasing': 1e-6, 'patience': 2},
               {'cg_iter': 200, 'cg_tol': 1e-9, 'steps': 3,
                'decreasing': 1e-7, 'patience': 2}]}
TINY_LIMITS = {'limits': {'chi2_gap': 1e-4, 'pose_chi2_gap': 1e-4,
                          'history_gap': 1e-3, 'steps_misses': 0,
                          'route_misses': 0}}


def make_root(dst, extra_metrics=()):
    """A checkout-like root at ``dst``: a copy of the benchmark's folder,
    the tiny configuration, traffic and limits, and a BENCHMARK.json of
    the repository's with the tiny cell (workload 'tiny.se3') added."""
    shutil.copytree(BENCH, dst / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    (dst / 'portbench/configs/tiny.json').write_text(json.dumps(TINY_CONFIG))
    (dst / 'portbench/traffic/tiny_mix.json').write_text(
        json.dumps(TINY_TRAFFIC))
    (dst / 'portbench/limits/tiny.se3.json').write_text(
        json.dumps(TINY_LIMITS))
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    bench['configs'].append({'name': 'tiny', 'source': 'test',
                             'file': 'portbench/configs/tiny.json',
                             'reduced': ['n_poses'], 'why': 'test'})
    bench['workloads'].append({'name': 'tiny.se3', 'config': 'tiny',
                               'traffic': 'tiny_mix', 'chips': 1,
                               'why': 'test'})
    for m in bench['per_layer']:
        m['workloads'] = m['workloads'] + ['tiny.se3']
    bench['per_layer'] += list(extra_metrics)
    (dst / 'BENCHMARK.json').write_text(json.dumps(bench, indent=1))
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture
def cuda_device():
    """Skips where no card is present (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return 'cuda'
