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
