"""The port's trajectory metric at the sizes of chip_smoke.py's
[traj-eval] on the CPU, against the JAX package's results on the same
arrays (``data/jax_anchor_metric.json``):

- sphere2500: ``synthetic_sphere(2500)``'s ground truth against its
  initial poses (the port's instance, crossed over as numpy), through
  ``testing.SPHERE_METRICS`` (aligned APE, Sim3-aligned APE in degrees,
  frame RPE, all-pairs distance RPE);
- EuRoC-like: ``testing.euroc_instance()`` (36,000 reference poses at
  200 Hz, 3,600 estimated at 20 Hz with +-2 ms of stamp jitter), through
  ``testing.EUROC_METRICS`` (Sim3-aligned APE; all-pairs RPE at 1 m).

Every statistic within ``testing.METRIC_ATOL + METRIC_RTOL |value|``
(float32; the Umeyama SVD differs between LAPACK builds).  Write the
anchor (~1 min; the JAX association builds a 3,600 x 36,000 distance
matrix, 1 GB) with
``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_metric_anchor.py``.
"""

import json
import sys
import time

import numpy as np

from pypose_tpu_torch.datasets import find_data, synthetic_sphere
from pypose_tpu_torch.metric import ape, rpe
from pypose_tpu_torch.testing import (EUROC_METRICS, SPHERE_METRICS,
                                      abs_sums, cap_threads, euroc_instance,
                                      instance_checksum, metric_failures,
                                      metric_stats)

cap_threads()

ANCHOR = 'jax_anchor_metric.json'
PORT = {'ape': ape, 'rpe': rpe}


def sphere_pair(device='cpu'):
    ds = synthetic_sphere(2500, device=device)
    stamps = np.arange(2500, dtype=np.float64)
    return ds, (stamps, ds['gt'], stamps, ds['nodes'])


def euroc_checksum(d):
    return abs_sums({k: d[k] for k in ('rpose', 'epose')})


def test_sphere2500_metric_matches_anchor():
    with open(find_data(ANCHOR)) as f:
        anchor = json.load(f)
    ds, pair = sphere_pair()
    assert instance_checksum(ds) == anchor['sphere2500']['instance_checksum']
    got = metric_stats(PORT, SPHERE_METRICS, *pair)
    bad, _ = metric_failures(anchor['sphere2500']['stats'], got)
    assert not bad, bad


def test_euroc_metric_matches_anchor():
    with open(find_data(ANCHOR)) as f:
        anchor = json.load(f)
    d = euroc_instance(device='cpu')
    assert euroc_checksum(d) == anchor['euroc']['instance_checksum']
    got = metric_stats(PORT, EUROC_METRICS, d['rstamp'], d['rpose'],
                       d['estamp'], d['epose'])
    bad, _ = metric_failures(anchor['euroc']['stats'], got)
    assert not bad, bad


def _jax_stats(cases, rstamp, rpose, estamp, epose):
    import jax.numpy as jnp
    import pypose_tpu as jpp
    from pypose_tpu.metric import ape as jape, rpe as jrpe

    def cross(x):
        return jpp.SE3(jnp.asarray(x.tensor().cpu().numpy()))
    return metric_stats({'ape': jape, 'rpe': jrpe}, cases, rstamp,
                        cross(rpose), estamp, cross(epose))


if __name__ == '__main__':
    from _anchor import write_anchor
    out, seconds = {}, {}
    ds, pair = sphere_pair()
    d = euroc_instance(device='cpu')
    euroc = (d['rstamp'], d['rpose'], d['estamp'], d['epose'])
    for name, cases, args in (('sphere2500', SPHERE_METRICS, pair),
                              ('euroc', EUROC_METRICS, euroc)):
        t0 = time.perf_counter()
        want = _jax_stats(cases, *args)
        seconds[f'{name}_jax'] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
        got = metric_stats(PORT, cases, *args)
        seconds[f'{name}_port_cpu'] = round(time.perf_counter() - t0, 1)
        bad, worst = metric_failures(want, got)
        print(f'{name}: JAX {want}; port CPU largest gap {worst:.3e} '
              f'{bad}', flush=True)
        out[name] = {'stats': want, 'port_cpu_stats': got,
                     'port_cpu_largest_gap': worst}
    out['sphere2500']['instance_checksum'] = instance_checksum(ds)
    out['euroc']['instance_checksum'] = euroc_checksum(d)
    write_anchor('metric', 'tests/test_torch_metric_anchor.py', {
        'problem': 'testing.SPHERE_METRICS on synthetic_sphere(2500) '
                   '(gt against the initial nodes) and testing.'
                   'EUROC_METRICS on testing.euroc_instance(), float32',
        **out,
        'tolerance': 'testing.METRIC_ATOL + METRIC_RTOL |value| for every '
                     'statistic',
        'seconds': seconds})
    sys.exit(0)
