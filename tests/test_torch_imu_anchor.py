"""The JAX anchor of the IMU cell: ``bench.py:bench_imu``'s input
(``testing.imu_instance('bench', F)``: constant gyro (0, 0, 0.3), acc
(0.2, 0, 9.81007), dt 0.005) at F = 1,000,000 frames through
``IMUPreintegrator(reset=True, prop_cov=True)``, in float32 as the JAX
package computes it and in float64 beside it:
``data/jax_anchor_imu_1m.json``.

Write the file (the JAX package at F = 1e6 in float32 and float64, then
the port's CPU run, whose spread from the JAX result sets the
tolerances; ~1 min):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_imu_anchor.py

Why the float32 result is the target.  Every frame's quaternion
so3(gyro dt).Exp() is the same float32 value in both packages, whose
squared norm falls short of 1 by 3.35e-8, and the cumulative product is
not renormalised (``pypose_tpu/basics/ops.py:_cum_quat``), so |q| at the
last frame is ~0.9912 and the float32 position is far from the float64
one (x 14661.8 against 4.97).  The port reproduces that drift; it is held
to the JAX package's float32 output, not to float64 or to the analytic
circle.

Tolerances.  The port combines the quaternion scan in the JAX order, but
the JAX package's jitted XLA program contracts the products into FMAs,
so the two differ in the last bits at every level; the script records
the port's CPU spread from the anchor per quantity (rot, vel, pos, cov,
|q|) and the tolerance is twice that spread plus 1e-6 of the quantity's
largest magnitude.  The float64 port is held to the float64 anchor within
1e-7 relative (the position sums 1e6 frames).
"""

import json
import sys
import time

import numpy as np
import torch

from pypose_tpu_torch.datasets import find_data
from pypose_tpu_torch.module import IMUPreintegrator
from pypose_tpu_torch.testing import imu_instance

ANCHOR = 'jax_anchor_imu_1m.json'
F = 1_000_000
KEYS = ('rot', 'vel', 'pos', 'cov')


def last_frame(out):
    """rot, vel, pos at the last frame and the 9x9 cov, as float64 lists,
    and |q| at the last frame."""
    def arr(v):
        v = v.tensor() if hasattr(v, 'tensor') else v
        return np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v)
                          else v, np.float64)
    res = {k: arr(out[k])[0, -1].tolist() for k in ('rot', 'vel', 'pos')}
    res['cov'] = arr(out['cov'])[0].tolist()
    res['q_norm'] = float(np.linalg.norm(res['rot']))
    return res


def port_run(dtype=torch.float32, device='cpu', frames=F):
    integ = IMUPreintegrator(reset=True, prop_cov=True, dtype=dtype,
                             device=device)
    return last_frame(integ(*imu_instance('bench', frames, device=device,
                                          dtype=dtype)))


def spread(got, want):
    """Largest |got - want| per quantity."""
    return {k: float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max())
            for k in KEYS + ('q_norm',)}


def tolerance(anchor, key):
    return 2 * anchor['port_cpu_spread'][key] + 1e-6 * np.abs(
        np.asarray(anchor['float32'][key])).max()


def check(got, anchor):
    """Failures of ``got`` (last_frame) against the float32 anchor."""
    bad = []
    for k in KEYS + ('q_norm',):
        err = float(np.abs(np.asarray(got[k])
                           - np.asarray(anchor['float32'][k])).max())
        if not err <= tolerance(anchor, k):
            bad.append(f'{k}: {err:.3e} > {tolerance(anchor, k):.3e}')
    return bad


def test_port_cpu_matches_anchor():
    with open(find_data(ANCHOR)) as f:
        anchor = json.load(f)
    got = port_run()
    assert not check(got, anchor), check(got, anchor)
    # the reference's norm drift is reproduced, not repaired
    assert abs(got['q_norm'] - 0.99120563) < 1e-5
    assert np.isfinite(np.asarray(got['cov'])).all()


def test_port_cpu_f64_matches_anchor():
    with open(find_data(ANCHOR)) as f:
        anchor = json.load(f)
    got = port_run(torch.float64)
    for k in KEYS:
        want = np.asarray(anchor['float64'][k])
        np.testing.assert_allclose(got[k], want, rtol=1e-7,
                                   atol=1e-7 * np.abs(want).max(),
                                   err_msg=k)
    assert abs(got['q_norm'] - 1) < 1e-9


def _jax_run(x64):
    import jax
    import jax.numpy as jnp
    from pypose_tpu.module import IMUPreintegrator as JIMU
    with jax.enable_x64(x64):
        dt = jnp.float64 if x64 else jnp.float32
        x = [jnp.asarray(a.numpy()) for a in imu_instance(
            'bench', F, device='cpu',
            dtype=torch.float64 if x64 else torch.float32)]
        assert all(a.dtype == dt for a in x)
        return last_frame(JIMU(reset=True, prop_cov=True)(*x))


if __name__ == '__main__':
    from _anchor import write_anchor
    t0 = time.perf_counter()
    j32 = _jax_run(False)
    j64 = _jax_run(True)
    jax_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p32 = port_run()
    port_s = time.perf_counter() - t0
    sp = spread(p32, j32)
    print(f'JAX float32 last frame: {j32["rot"]} {j32["vel"]} {j32["pos"]} '
          f'|q| {j32["q_norm"]}; float64 pos {j64["pos"]}', flush=True)
    print(f'port CPU spread from the JAX float32 result: {sp}', flush=True)
    write_anchor('imu_1m', 'tests/test_torch_imu_anchor.py', {
        'problem': f"bench.py:bench_imu at F={F}: testing.imu_instance("
                   f"'bench', {F}), IMUPreintegrator(reset=True, "
                   f"prop_cov=True); the last frame's rot, vel, pos and "
                   f"the 9x9 cov",
        'float32': j32, 'float64': j64, 'port_cpu_float32': p32,
        'port_cpu_spread': sp,
        'tolerance': 'twice port_cpu_spread plus 1e-6 of the largest '
                     '|value| of the quantity',
        'seconds': {'jax_f32_and_f64': round(jax_s, 1),
                    'port_cpu': round(port_s, 1)}})
    sys.exit(0)
