"""The JAX anchor of ShardedBA on the ba-trafalgar cell.

``testing.ba_instance('ba-trafalgar')`` (synthetic_bal at 257 cameras,
65,132 points, 225,911 observations, float32) through ``ShardedBA`` with
the cell's schedule (``testing.BA_SCHEDULES['ba-trafalgar']``: camera 0
fixed, TrustRegion, the dense Schur route, ``optimize(steps=5,
patience=3, decreasing=1e-3)``).  The target is what the JAX package's
ShardedBA computes over 8 virtual CPU devices (225,911 observations
padded to 225,912), ``data/jax_anchor_sharded_ba.json``.  Write it (JAX,
then the port at one CPU rank; ~2 min):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_sharded_ba_anchor.py

The JAX ShardedBA's fourth step sits on a TrustRegion rejection (its
chi2 94,150.34 then 94,150.37), so its final (68,480) is one step behind
the JAX BundleAdjustment's (65,385, data/jax_anchor_ba_trafalgar.json)
and the port's (65,385 at one CPU rank): ``chip_smoke.py`` [sharded-ba]
holds the card to the latter within 2e-2 and prints this anchor beside
it.  The test here checks the instance the anchor was made on.
"""

import json
import os
import time

import numpy as np

from pypose_tpu_torch.datasets import find_data
from pypose_tpu_torch.testing import (BA_SCHEDULES, bal_checksum, ba_instance,
                                      cap_threads)

cap_threads()

ANCHOR = 'jax_anchor_sharded_ba.json'
CELL = 'ba-trafalgar'


def _anchor():
    with open(find_data(ANCHOR)) as f:
        return json.load(f)


def optimize_args():
    s = BA_SCHEDULES[CELL]
    return dict(steps=s['steps'], patience=s['patience'],
                decreasing=s['decreasing'])


def ba_args():
    return {k: v for k, v in BA_SCHEDULES[CELL].items()
            if k not in ('steps', 'patience', 'decreasing')}


def test_instance_matches_anchor():
    got = bal_checksum(ba_instance(CELL, device='cpu'))
    want = _anchor()['instance_checksum']
    assert got['n_obs'] == want['n_obs'] == 225_911
    for key in ('poses_abs_sum', 'points_abs_sum', 'pixels_abs_sum'):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)


def _jax_run(ds):
    """The JAX package's ShardedBA over 8 virtual CPU devices, crossed
    over as numpy: (history, final, initial, route, seconds)."""
    import jax
    import jax.numpy as jnp
    from pypose_tpu.lietensor.utils import SE3
    from pypose_tpu.parallel import ShardedBA, make_mesh
    assert len(jax.devices()) >= 8
    t0 = time.perf_counter()
    opt = ShardedBA(SE3(jnp.asarray(ds['poses'].tensor().numpy())),
                    jnp.asarray(ds['points'].numpy()),
                    jnp.asarray(ds['cam_idx'].numpy().astype(np.int32)),
                    jnp.asarray(ds['pt_idx'].numpy().astype(np.int32)),
                    jnp.asarray(ds['pixels'].numpy()),
                    jnp.asarray(ds['cameras'].numpy()),
                    mesh=make_mesh(8), **ba_args())
    initial = float(opt._chi2(opt.poses.tensor(), opt.points))
    final = opt.optimize(**optimize_args())
    route = 'dense' if opt._use_dense_schur else 'cg'
    return ([float(h) for h in opt.history], float(final), initial, route,
            time.perf_counter() - t0)


def main():
    os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '') +
                               ' --xla_force_host_platform_device_count=8')
    import jax
    jax.config.update('jax_platforms', 'cpu')
    import torch
    import torch.distributed as dist
    from _anchor import write_anchor
    from pypose_tpu_torch.parallel import ShardedBA, make_mesh
    ds = ba_instance(CELL, device='cpu')
    hist, final, initial, route, jax_s = _jax_run(ds)
    print(f'JAX ShardedBA (8 devices, {route}): chi2 {initial} -> {hist} in '
          f'{jax_s:.1f} s', flush=True)
    t0 = time.perf_counter()
    opt = ShardedBA(ds['poses'], ds['points'], ds['cam_idx'], ds['pt_idx'],
                    ds['pixels'], ds['cameras'],
                    mesh=make_mesh(device_type='cpu'), **ba_args())
    port_final = opt.optimize(**optimize_args())
    port_s = time.perf_counter() - t0
    dist.destroy_process_group()
    gap = port_final / final - 1
    print(f'port ShardedBA (one CPU rank): {opt.history} in {port_s:.1f} s; '
          f'final relative gap {gap:.3e}', flush=True)
    write_anchor('sharded_ba', 'tests/test_torch_sharded_ba_anchor.py', {
        'problem': f"pypose_tpu_torch.testing.ba_instance('{CELL}'), "
                   'float32, built on the CPU, crossed over as numpy',
        'instance_checksum': bal_checksum(ds),
        'schedule': BA_SCHEDULES[CELL], 'route': route,
        'reference': 'pypose_tpu.parallel.ShardedBA over make_mesh(8) on the '
                     'JAX CPU backend with 8 virtual devices',
        'initial_chi2': initial, 'history': hist, 'final_chi2': final,
        'port_cpu_check': {'ranks': 1, 'history': opt.history,
                           'final_chi2': port_final, 'relative_gap': gap,
                           'torch': torch.__version__},
        'seconds': {'jax': round(jax_s, 1), 'port_cpu': round(port_s, 1)}})


if __name__ == '__main__':
    main()
