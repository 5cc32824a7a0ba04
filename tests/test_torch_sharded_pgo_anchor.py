"""The JAX anchor of ShardedPGO on the vendored sphere2500 graph.

``data/synthetic_sphere2500_seed42.g2o`` (2,500 poses, 4,499 edges with
identity information matrices) through ``ShardedPGO(nodes, edges, poses,
infos, cg_iter=150, cg_tol=1e-6)`` (TrustRegion(1e4), node 0 fixed, the
generic matvec) and ``run(10)``: examples/pgo.py's schedule.  The target
is what the JAX package's ShardedPGO computes over 8 virtual CPU devices
(4,499 edges padded to 4,504), ``data/jax_anchor_sharded_pgo.json``.
Write it (JAX, then the port at one CPU rank; ~3 min):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_sharded_pgo_anchor.py

Tolerance: the port's final chi2 at one CPU rank within 1e-3 relative of
the anchor's (float32, as ``chip_smoke.py`` [sharded-pgo] holds the
card).
"""

import json
import os
import time

import numpy as np

from pypose_tpu_torch.datasets import find_data, load_g2o
from pypose_tpu_torch.testing import cap_threads, instance_checksum

cap_threads()

ANCHOR = 'jax_anchor_sharded_pgo.json'
G2O = 'synthetic_sphere2500_seed42.g2o'
SCHEDULE = dict(cg_iter=150, cg_tol=1e-6, steps=10)
RTOL = 1e-3


def _anchor():
    with open(find_data(ANCHOR)) as f:
        return json.load(f)


def port_run(ds, mesh):
    """The port's ShardedPGO on ``ds`` over ``mesh``: (history, final)."""
    from pypose_tpu_torch.parallel import ShardedPGO
    opt = ShardedPGO(ds['nodes'], ds['edges'], ds['poses'],
                     infos=ds['infos'], mesh=mesh,
                     cg_iter=SCHEDULE['cg_iter'], cg_tol=SCHEDULE['cg_tol'])
    final = opt.run(SCHEDULE['steps'])
    return list(opt.history), final


def test_instance_matches_anchor():
    got = instance_checksum(load_g2o(find_data(G2O), device='cpu'))
    want = _anchor()['instance_checksum']
    assert got['n_edges'] == want['n_edges'] == 4499
    for key in ('nodes_abs_sum', 'poses_abs_sum'):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)


def test_one_rank_matches_anchor():
    import torch.distributed as dist
    from pypose_tpu_torch.parallel import make_mesh
    assert not dist.is_initialized()
    try:
        hist, final = port_run(load_g2o(find_data(G2O), device='cpu'),
                               make_mesh(device_type='cpu'))
    finally:
        dist.destroy_process_group()
    anchor = _anchor()
    assert len(hist) == SCHEDULE['steps']
    np.testing.assert_allclose(final, anchor['final_chi2'], rtol=RTOL)
    assert final < 1e-2 * anchor['initial_chi2']


def _jax_run(ds):
    """The JAX package's ShardedPGO over 8 virtual CPU devices on the
    instance, crossed over as numpy: (history, final, initial, seconds)."""
    import jax
    import jax.numpy as jnp
    from pypose_tpu.lietensor.utils import SE3
    from pypose_tpu.parallel import ShardedPGO, make_mesh
    assert len(jax.devices()) >= 8
    t0 = time.perf_counter()
    opt = ShardedPGO(SE3(jnp.asarray(ds['nodes'].tensor().numpy())),
                     jnp.asarray(ds['edges'].numpy().astype(np.int32)),
                     SE3(jnp.asarray(ds['poses'].tensor().numpy())),
                     infos=jnp.asarray(ds['infos'].numpy()),
                     mesh=make_mesh(8), cg_iter=SCHEDULE['cg_iter'],
                     cg_tol=SCHEDULE['cg_tol'])
    initial = float(opt.lm._chi2(opt.lm.params, opt.lm._factor_data()))
    final = opt.run(SCHEDULE['steps'])
    return ([float(h) for h in opt.history], float(final), initial,
            time.perf_counter() - t0)


def main():
    os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '') +
                               ' --xla_force_host_platform_device_count=8')
    import jax
    jax.config.update('jax_platforms', 'cpu')
    import torch.distributed as dist
    from _anchor import write_anchor
    from pypose_tpu_torch.parallel import make_mesh
    ds = load_g2o(find_data(G2O), device='cpu')
    hist, final, initial, jax_s = _jax_run(ds)
    print(f'JAX ShardedPGO (8 devices): chi2 {initial} -> {hist} in '
          f'{jax_s:.1f} s', flush=True)
    t0 = time.perf_counter()
    port_hist, port_final = port_run(ds, make_mesh(device_type='cpu'))
    port_s = time.perf_counter() - t0
    dist.destroy_process_group()
    gap = port_final / final - 1
    print(f'port ShardedPGO (one CPU rank): {port_hist} in {port_s:.1f} s; '
          f'final relative gap {gap:.3e}', flush=True)
    write_anchor('sharded_pgo', 'tests/test_torch_sharded_pgo_anchor.py', {
        'problem': f'data/{G2O} through the port\'s load_g2o (float32), '
                   'crossed over as numpy',
        'instance_checksum': instance_checksum(ds),
        'schedule': SCHEDULE,
        'reference': 'pypose_tpu.parallel.ShardedPGO over make_mesh(8) on '
                     'the JAX CPU backend with 8 virtual devices, '
                     'TrustRegion(radius=1e4), node 0 fixed, run(10)',
        'initial_chi2': initial, 'history': hist, 'final_chi2': final,
        'port_cpu_check': {'ranks': 1, 'history': port_hist,
                           'final_chi2': port_final, 'relative_gap': gap},
        'seconds': {'jax': round(jax_s, 1), 'port_cpu': round(port_s, 1)}})


if __name__ == '__main__':
    main()
