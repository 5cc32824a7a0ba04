"""The port's splines at the size of chip_smoke.py's [spline] on the CPU,
against the JAX package on the same arrays (``data/jax_anchor_spline.json``):
``bspline`` over ``testing.spline_instance()``'s 60,000 SE3 control poses
at interval 0.1 (599,971 poses) and with ``extrapolate=True`` (600,011),
and ``chspline`` over its 60,000 waypoints in R^3 (599,991 points),
float32.  The anchor keeps ``testing.spline_summary`` of each output
(every 1,000th row, column sums, maxima, magnitudes); the port is held by
``testing.spline_failures`` (``SPLINE_RTOL`` of each column's magnitude:
measured 4 float32 ulps between the packages).  Write it (~30 s) with
``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_spline_anchor.py``.
"""

import json
import sys
import time

import numpy as np

import pypose_tpu_torch as ppt
from pypose_tpu_torch.datasets import find_data
from pypose_tpu_torch.testing import (abs_sums, cap_threads, spline_calls,
                                      spline_failures, spline_instance,
                                      spline_summary)

cap_threads()

ANCHOR = 'jax_anchor_spline.json'


def test_splines_match_anchor():
    with open(find_data(ANCHOR)) as f:
        anchor = json.load(f)
    d = spline_instance(device='cpu')
    assert abs_sums(d) == anchor['instance_checksum']
    for name, run in spline_calls(ppt, d).items():
        bad, _ = spline_failures(anchor[name], spline_summary(run()))
        assert not bad, (name, bad)


if __name__ == '__main__':
    import jax.numpy as jnp
    import pypose_tpu as jpp
    from _anchor import write_anchor
    d = spline_instance(device='cpu')
    jd = {'poses': jpp.SE3(jnp.asarray(d['poses'].tensor().numpy())),
          'points': jnp.asarray(d['points'].numpy())}
    out, seconds = {}, {}
    for (name, jrun), prun in zip(spline_calls(jpp, jd).items(),
                                  spline_calls(ppt, d).values()):
        t0 = time.perf_counter()
        x = jrun()
        x = np.asarray(x.tensor() if hasattr(x, 'tensor') else x)
        seconds[name] = round(time.perf_counter() - t0, 1)
        out[name] = spline_summary(x)
        bad, gaps = spline_failures(out[name], spline_summary(prun()))
        print(f'{name}: {out[name]["rows"]} rows; port CPU gaps {gaps} '
              f'{bad}', flush=True)
        out[name]['port_cpu_gaps'] = gaps
    write_anchor('spline', 'tests/test_torch_spline_anchor.py', {
        'problem': 'testing.spline_instance(): bspline(poses, 0.1), '
                   'bspline(poses, 0.1, extrapolate=True), chspline(points, '
                   '0.1), float32; testing.spline_summary of each',
        'instance_checksum': abs_sums(d), **out,
        'tolerance': 'testing.spline_failures (SPLINE_RTOL of each '
                     "column's magnitude)",
        'seconds_jax': seconds})
    sys.exit(0)
