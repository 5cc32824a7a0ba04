"""The JAX anchors of the port's pose graphs over SO3, RxSO3 and Sim3.

Six instances, each ``pypose_tpu_torch.testing.pgo_group_instance`` of an
SE3 graph (scale draw from ``torch.Generator`` seed 7 on the CPU):

- ``{so3,rxso3,sim3}-sphere2500``: ``data/synthetic_sphere2500_seed42.g2o``;
  TrustRegion(1e4), cg_iter 150, cg_tol 1e-8, ``optimize(steps=6,
  decreasing=1e-6, patience=2)``.  One merged stencil within the
  whole-solve budget: the port's 'stencil' route, the JAX package's plain
  stencil CG off the TPU.
- ``{so3,rxso3,sim3}-100k``: ``synthetic_sphere(100000, seed=42)`` with
  ``bench.py:bench_pgo_100k``'s schedule (cg_iter 250, cg_tol 1e-3, six
  steps).  Past that budget: the port's fused solver, the JAX package's
  einsum CG off the TPU (block-Jacobi scalarized at t = 3, through
  ``jnp.linalg.inv`` at t = 4 and 7), the same system to the same
  tolerance.

The target of each is what the JAX package's ``SparseLM`` computes on
exactly the port's instance, ``data/jax_anchor_<name>.json``.  Write them
(JAX on the CPU, then the port on the CPU; all six take ~6 minutes, or
name the ones to write):

    PYTHONPATH=. JAX_PLATFORMS=cpu python \\
        tests/test_torch_pgo_groups_anchor.py [name ...]

Tolerances, float32, the port's CPU run against the anchor (recorded in
each file as ``port_cpu_check``): see ``HOLD`` below.  The tests run one
LM step of the port on the CPU at full size and hold its chi2 to the
anchor's first entry.
"""

import json
import sys

import numpy as np
import pytest

import torch

from pypose_tpu_torch.datasets import find_data, load_g2o, synthetic_sphere
from pypose_tpu_torch.testing import (instance_checksum, pgo_group_instance,
                                      pgo_optimizer)

SCALE_SEED = 7
SPHERE = dict(radius=1e4, cg_iter=150, cg_tol=1e-8, steps=6,
              decreasing=1e-6, patience=2)
# bench.py:713-720 (bench_pgo_100k)
BIG = dict(radius=1e4, cg_iter=250, cg_tol=1e-3, steps=6, decreasing=1e-6,
           patience=2)
ANCHORS = {
    'so3_sphere2500': ('SO3', 'sphere2500', SPHERE),
    'rxso3_sphere2500': ('RxSO3', 'sphere2500', SPHERE),
    'sim3_sphere2500': ('Sim3', 'sphere2500', SPHERE),
    'so3_100k': ('SO3', '100k', BIG),
    'rxso3_100k': ('RxSO3', '100k', BIG),
    'sim3_100k': ('Sim3', '100k', BIG),
}
# name -> (first-step rtol, final rtol) of a float32 run against the
# anchor.  Measured on the CPU (each file's port_cpu_check) and on an H100
# (chip_smoke.py): the first step follows the same solve to the same
# tolerance by another recursion and summation order; later steps inherit
# the difference.
HOLD = {
    'so3_sphere2500': (1e-4, 1e-3),
    'rxso3_sphere2500': (1e-4, 1e-3),
    'sim3_sphere2500': (1e-4, 1e-3),
    'so3_100k': (1e-4, 1e-3),
    'rxso3_100k': (1e-4, 1e-3),
    'sim3_100k': (1e-4, 1e-3),
}


def base_graph(which, device='cpu'):
    """The SE3 graph an anchor's instance is built from."""
    if which == 'sphere2500':
        return load_g2o(find_data('synthetic_sphere2500_seed42.g2o'),
                        device=device)
    return synthetic_sphere(100_000, seed=42, device=device)


def instance(name, device='cpu'):
    group, which, _ = ANCHORS[name]
    return pgo_group_instance(base_graph(which, device), group,
                              torch.Generator().manual_seed(SCALE_SEED))


def load_anchor(name):
    with open(find_data(f'jax_anchor_{name}.json')) as f:
        return json.load(f)


def check_history(name, hist, anchor):
    """HOLD's tolerances for a float32 chi2 history ``hist``."""
    first, final = HOLD[name]
    assert len(hist) == len(anchor['history'])
    np.testing.assert_allclose(hist[0], anchor['history'][0], rtol=first)
    np.testing.assert_allclose(hist[-1], anchor['final_chi2'], rtol=final)


@pytest.mark.parametrize('name', list(ANCHORS))
def test_instance_and_first_step_match_anchor(name):
    """The port still builds the instance the anchor was computed on (edge
    count; float64 sums of |nodes| and |poses| within 1e-6), takes the
    'stencil' route, and its first LM step on the CPU meets the JAX
    package's."""
    anchor = load_anchor(name)
    ds = instance(name)
    got, want = instance_checksum(ds), anchor['instance_checksum']
    assert got['n_edges'] == want['n_edges']
    for key in ('nodes_abs_sum', 'poses_abs_sum'):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)
    opt = pgo_optimizer(ds, **anchor['schedule'])
    assert opt.route == 'stencil'
    np.testing.assert_allclose(opt.step(), anchor['history'][0],
                               rtol=HOLD[name][0])
    assert len(opt.cg_iterations[0]) >= 1
    assert 0 < opt.cg_iterations[0][0] <= anchor['schedule']['cg_iter']


@pytest.mark.parametrize('name', list(ANCHORS))
def test_recorded_port_run_within_hold(name):
    """The port's full CPU schedule, recorded beside the anchor when it was
    written, is within HOLD of it."""
    anchor = load_anchor(name)
    assert anchor['port_cpu_check']['route'] == 'stencil'
    check_history(name, anchor['port_cpu_check']['history'], anchor)


def main(names):
    import jax
    jax.config.update('jax_platforms', 'cpu')
    from _anchor import jax_pgo_run, write_jax_anchor
    for name in names or ANCHORS:
        group, which, sched = ANCHORS[name]
        write_jax_anchor(
            f'jax_anchor_{name}.json',
            f'pypose_tpu_torch.testing.pgo_group_instance of the {which} '
            f'SE3 graph over {group}, scale draw seed {SCALE_SEED}, '
            'float32, built on the CPU', instance(name), sched,
            lambda ds: jax_pgo_run(ds, group, sched),
            lambda ds: pgo_optimizer(ds, **sched),
            group=group, graph=which, scale_seed=SCALE_SEED,
            reference='pypose_tpu.optim.sparse.SparseLM on the JAX CPU '
                      'backend, factors as bench.py builds its pose graphs',
            command='PYTHONPATH=. JAX_PLATFORMS=cpu python '
                    f'tests/test_torch_pgo_groups_anchor.py {name}')


if __name__ == '__main__':
    main(sys.argv[1:])
