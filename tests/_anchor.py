"""Writes a JAX anchor: the JAX package's SparseLM run on one of the port's
pose-graph instances, beside the port's CPU run, as the anchor test
scripts' ``__main__`` records it (``tests/test_torch_pgo_chain_anchor.py``,
``tests/test_torch_pgo_loops_anchor.py``)."""

import json
import os
import subprocess
import time

from pypose_tpu_torch.testing import instance_checksum


def write_jax_anchor(name, problem, ds, schedule, jax_run, port_optimizer,
                     **extra):
    """Run ``jax_run(ds)`` -> (chi2 history, final chi2, the JAX package's
    preconditioner, initial chi2), then the port's
    ``port_optimizer(ds).optimize`` with ``schedule``'s steps, decreasing
    and patience, and write both, with the instance's checksum and the
    seconds each took, to the repository's ``data/name``."""
    t0 = time.perf_counter()
    hist, final, precond, initial = jax_run(ds)
    jax_s = time.perf_counter() - t0
    print(f'JAX SparseLM ({precond}): chi2 {initial} -> {hist} in '
          f'{jax_s:.1f} s', flush=True)
    t0 = time.perf_counter()
    opt = port_optimizer(ds)
    port_final = opt.optimize(steps=schedule['steps'],
                              decreasing=schedule['decreasing'],
                              patience=schedule['patience'])
    port_s = time.perf_counter() - t0
    gap = port_final / final - 1
    print(f'port CPU SparseLM ({opt.route}): chi2 history {opt.history}, '
          f'CG iterations {opt.cg_iterations}, in {port_s:.1f} s; final '
          f'relative gap {gap:.3e}', flush=True)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    commit = subprocess.run(['git', 'rev-parse', 'HEAD'], cwd=repo,
                            capture_output=True, text=True).stdout.strip()
    out = {'problem': problem, 'instance_checksum': instance_checksum(ds),
           'schedule': schedule, 'jax_precond': precond,
           'initial_chi2': initial, 'history': hist, 'final_chi2': final,
           'port_cpu_check': {'route': opt.route, 'history': opt.history,
                              'final_chi2': port_final,
                              'relative_gap': gap,
                              'cg_iterations': opt.cg_iterations},
           'commit': f'{commit} with the working tree that added this file',
           'seconds': {'jax': round(jax_s, 1), 'port_cpu': round(port_s, 1)},
           **extra}
    with open(os.path.join(repo, 'data', name), 'w') as f:
        json.dump(out, f, indent=1)
        f.write('\n')


def write_anchor(name, script, out):
    """Write ``out`` to the repository's ``data/jax_anchor_<name>.json``
    with the commit it was computed on and the command that writes it
    (``PYTHONPATH=. JAX_PLATFORMS=cpu python <script>``)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    commit = subprocess.run(['git', 'rev-parse', 'HEAD'], cwd=repo,
                            capture_output=True, text=True).stdout.strip()
    out['commit'] = f'{commit} with the working tree that added this file'
    out['command'] = f'PYTHONPATH=. JAX_PLATFORMS=cpu python {script}'
    with open(os.path.join(repo, 'data', f'jax_anchor_{name}.json'),
              'w') as f:
        json.dump(out, f, indent=1)
        f.write('\n')


def jax_pgo_optimizer(ds, group, schedule, kernel=None, cg_iter=None):
    """The JAX package's SparseLM over ``group`` ('SO3', 'SE3', 'RxSO3',
    'Sim3') on a port pose-graph dict, crossed over as numpy, built as
    ``pypose_tpu_torch.testing.pgo_optimizer`` builds the port's (one
    ``pgo_factor`` an odometry run and one for the rest, or one for every
    edge, node 0 fixed), with the robust ``kernel`` if given and
    ``cg_iter`` in place of the schedule's if given."""
    import jax.numpy as jnp
    import numpy as np
    import pypose_tpu as jpp
    from pypose_tpu.optim.sparse import (SparseLM, pgo_factor,
                                         split_chain_edges)
    from pypose_tpu.optim.strategy import TrustRegion

    def lie(x):
        return getattr(jpp, group)(jnp.asarray(x.tensor().numpy()))
    edges = jnp.asarray(ds['edges'].numpy().astype(np.int32))
    Z = lie(ds['poses'])
    if schedule.get('split_chains', True):
        runs, rest = split_chain_edges(edges)
        factors = [pgo_factor(edges[jnp.asarray(r)], Z[jnp.asarray(r)],
                              kernel=kernel)
                   for r in list(runs) + ([rest] if len(rest) else [])]
    else:
        factors = [pgo_factor(edges, Z, kernel=kernel)]
    N = ds['nodes'].shape[0]
    return SparseLM({'poses': lie(ds['nodes'])}, factors,
                    strategy=TrustRegion(radius=schedule['radius']),
                    fixed={'poses': jnp.zeros(N, bool).at[0].set(True)},
                    cg_iter=cg_iter or schedule['cg_iter'],
                    cg_tol=schedule['cg_tol'])


def jax_pgo_run(ds, group, schedule):
    """:func:`jax_pgo_optimizer` run with ``schedule``'s optimize: (chi2
    history, final chi2, its preconditioner, initial chi2), the
    ``jax_run`` of :func:`write_jax_anchor`."""
    opt = jax_pgo_optimizer(ds, group, schedule)
    initial = float(opt._chi2(opt.params, opt._factor_data()))
    final = opt.optimize(steps=schedule['steps'],
                         decreasing=schedule['decreasing'],
                         patience=schedule['patience'])
    return [float(h) for h in opt.history], float(final), opt.precond, \
        initial
