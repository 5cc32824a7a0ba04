"""The JAX anchor of the port's 100k-pose pose graph.

The port's ``synthetic_sphere`` draws its noise from a ``torch.Generator``,
so its 100k instance is not the JAX package's.  The correctness target for
the port's pgo-100k run is what the JAX package's ``SparseLM`` computes on
exactly the port's instance: ``data/jax_anchor_pgo100k_seed42.json``.

Write the file (one JAX CPU solve at 100k poses, a few minutes; then the
port's own CPU run on the same problem, whose gap to the anchor is
recorded beside it):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_pgo100k_anchor.py

The test below checks that the port still builds the instance the file
was computed on: same edge count, and the float64 sums of |nodes| and
|poses| within 1e-6 relative.  ``synthetic_sphere`` computes in float64
and rounds, so the instance is the same on every CPU vector path; the
tolerance leaves room for a last-bit difference on another machine
without letting another noise draw through (those move the sums by
~1e-4 relative).
"""

import json
import os
import subprocess
import time

import numpy as np

import torch

from pypose_tpu_torch.datasets import find_data, synthetic_sphere
from pypose_tpu_torch.testing import instance_checksum

ANCHOR = 'jax_anchor_pgo100k_seed42.json'
N, SEED = 100_000, 42
# bench.py:713-720 (bench_pgo_100k)
SCHEDULE = dict(radius=1e4, cg_iter=250, cg_tol=1e-3, steps=6,
                decreasing=1e-6, patience=2)


def test_instance_matches_anchor():
    with open(find_data(ANCHOR)) as f:
        anchor = json.load(f)
    got = instance_checksum(synthetic_sphere(N, seed=SEED, device='cpu'))
    want = anchor['instance_checksum']
    assert got['n_edges'] == want['n_edges'] == 179_999
    for key in ('nodes_abs_sum', 'poses_abs_sum'):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)


def test_first_step_matches_anchor(monkeypatch):
    """One LM step of the port's SparseLM on the CPU at full size, past
    the whole-solve budget so on the tiled route: chi2 within 1e-4 of the
    JAX package's first step (float32; both CGs stop at the same
    tolerance, in another summation order)."""
    from pypose_tpu_torch.ops import stencil_cg as scg
    calls = []
    plain = scg._tiled_cg_torch
    monkeypatch.setattr(scg, '_tiled_cg_torch',
                        lambda *a: calls.append(a) or plain(*a))
    with open(find_data(ANCHOR)) as f:
        anchor = json.load(f)
    opt = _port_optimizer(synthetic_sphere(N, seed=SEED, device='cpu'))
    chi2 = opt.step()
    np.testing.assert_allclose(chi2, anchor['history'][0], rtol=1e-4)
    assert len(calls) == len(opt.cg_iterations[0]) >= 1
    assert 0 < opt.cg_iterations[0][0] <= SCHEDULE['cg_iter']


def _jax_anchor(ds):
    """The JAX package's SparseLM on the port's instance, crossed over as
    numpy; bench.py:bench_pgo_100k's factors and schedule."""
    import jax.numpy as jnp
    from pypose_tpu.lietensor.utils import SE3
    from pypose_tpu.optim.sparse import (SparseLM, pgo_factor,
                                         split_chain_edges)
    from pypose_tpu.optim.strategy import TrustRegion

    edges = jnp.asarray(ds['edges'].numpy().astype(np.int32))
    Z = SE3(jnp.asarray(ds['poses'].tensor().numpy()))
    runs, rest = split_chain_edges(edges)
    factors = [pgo_factor(edges[jnp.asarray(r)], Z[jnp.asarray(r)])
               for r in list(runs) + ([rest] if len(rest) else [])]
    opt = SparseLM({'poses': SE3(jnp.asarray(ds['nodes'].tensor().numpy()))},
                   factors, strategy=TrustRegion(radius=SCHEDULE['radius']),
                   fixed={'poses': jnp.zeros(N, bool).at[0].set(True)},
                   cg_iter=SCHEDULE['cg_iter'], cg_tol=SCHEDULE['cg_tol'])
    final = opt.optimize(steps=SCHEDULE['steps'],
                         decreasing=SCHEDULE['decreasing'],
                         patience=SCHEDULE['patience'])
    return [float(h) for h in opt.history], float(final)


def _port_optimizer(ds):
    """The port's SparseLM on the CPU instance, as _jax_anchor builds
    the JAX one."""
    from pypose_tpu_torch.optim.sparse import (SparseLM, pgo_factor,
                                               split_chain_edges)
    from pypose_tpu_torch.optim.strategy import TrustRegion

    edges = ds['edges']
    runs, rest = split_chain_edges(edges)
    factors = [pgo_factor(edges[torch.as_tensor(r)],
                          ds['poses'][torch.as_tensor(r)])
               for r in list(runs) + ([rest] if len(rest) else [])]
    fixed = torch.zeros(N, dtype=torch.bool)
    fixed[0] = True
    return SparseLM({'poses': ds['nodes']}, factors,
                    strategy=TrustRegion(radius=SCHEDULE['radius']),
                    fixed={'poses': fixed}, cg_iter=SCHEDULE['cg_iter'],
                    cg_tol=SCHEDULE['cg_tol'])


def _port_cpu(ds):
    """The port's SparseLM on the CPU (the tiled route's plain version)."""
    opt = _port_optimizer(ds)
    final = opt.optimize(steps=SCHEDULE['steps'],
                         decreasing=SCHEDULE['decreasing'],
                         patience=SCHEDULE['patience'])
    return list(opt.history), final, opt.cg_iterations


def main():
    import jax
    jax.config.update('jax_platforms', 'cpu')
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ds = synthetic_sphere(N, seed=SEED, device='cpu')
    t0 = time.perf_counter()
    hist, final = _jax_anchor(ds)
    jax_s = time.perf_counter() - t0
    print(f'JAX SparseLM: chi2 history {hist} in {jax_s:.1f} s', flush=True)
    t0 = time.perf_counter()
    port_hist, port_final, port_its = _port_cpu(ds)
    port_s = time.perf_counter() - t0
    gap = port_final / final - 1
    print(f'port CPU SparseLM: chi2 history {port_hist}, CG iterations '
          f'{port_its}, in {port_s:.1f} s; final relative gap {gap:.3e}',
          flush=True)
    commit = subprocess.run(['git', 'rev-parse', 'HEAD'], cwd=repo,
                            capture_output=True, text=True).stdout.strip()
    out = {
        'problem': f'pypose_tpu_torch.datasets.synthetic_sphere({N}, '
                   f'seed={SEED}), float32, built on the CPU',
        'instance_checksum': instance_checksum(ds),
        'schedule': SCHEDULE,
        'reference': 'pypose_tpu.optim.sparse.SparseLM on the JAX CPU '
                     'backend: over the whole-CG kernel budget, so the '
                     'einsum CG (jax.scipy.sparse.linalg.cg, scalarized '
                     'block-Jacobi; pypose_tpu/optim/sparse.py:727-767), '
                     'same system and tolerance as the stencil CG',
        'history': hist,
        'final_chi2': final,
        'port_cpu_check': {'history': port_hist, 'final_chi2': port_final,
                           'relative_gap': gap},
        'commit': f'{commit} with the working tree that added this file',
        'command': 'PYTHONPATH=. JAX_PLATFORMS=cpu python '
                   'tests/test_torch_pgo100k_anchor.py',
        'seconds': {'jax': round(jax_s, 1), 'port_cpu': round(port_s, 1)},
    }
    with open(os.path.join(repo, 'data', ANCHOR), 'w') as f:
        json.dump(out, f, indent=1)
        f.write('\n')


if __name__ == '__main__':
    main()
