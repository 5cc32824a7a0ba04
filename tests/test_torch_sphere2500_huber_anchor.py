"""The JAX anchor of sphere2500 with a Huber kernel (sphere2500-huber).

The vendored ``data/synthetic_sphere2500_seed42.g2o`` through
``testing.pgo_optimizer`` with ``pgo_factor(..., kernel=Huber(5.0))``
(delta 5 as in ``tests/optim/test_sparse_lm.py:52-57``: at the start ~60%
of the edges lie past it; near the optimum every edge is quadratic, so the
run still reaches pypose's chi2) and ``bench.py:199-205``'s two-phase
schedule (``testing.two_phase``: cg_iter 150, then 1200, cg_tol 1e-9,
TrustRegion(1e4)); one merged stencil, so the 'stencil' route, with the
closed-form Jacobian and with the residual-only factor (Jacobian by
autodiff).  The target is what the JAX package's ``SparseLM`` computes on
this instance: ``data/jax_anchor_sphere2500_huber.json``.  Write it (JAX,
then the port's two Jacobian forms, on the CPU; ~3 minutes):

    PYTHONPATH=. JAX_PLATFORMS=cpu python \\
        tests/test_torch_sphere2500_huber_anchor.py

Tolerances, float32: the first step within 1e-4 (one LM step at full size
on the CPU, each Jacobian form), and the port's recorded CPU runs first
step 1e-4, final 1e-3 of the anchor and below pypose's chi2 (measured on
the CPU, two writes of the anchor: first steps 0.8e-5 to 1.7e-5 from it,
torch's CPU sums moving with the thread count; finals within 4.6e-6).
"""

import json

import numpy as np
import pytest

from pypose_tpu_torch.datasets import find_data, load_g2o
from pypose_tpu_torch.optim.kernel import Huber
from pypose_tpu_torch.testing import (instance_checksum, pgo_optimizer,
                                      two_phase)

HUBER_DELTA = 5.0
# bench.py:199-205: phase 1 (cg_iter 150); phase 2 (cg_iter 1200) in
# testing.two_phase
SPHERE = dict(radius=1e4, cg_iter=150, cg_tol=1e-9, polish_cg_iter=1200)
FIRST, FINAL = 1e-4, 1e-3


def load_anchor():
    with open(find_data('jax_anchor_sphere2500_huber.json')) as f:
        return json.load(f)


def sphere2500(device='cpu'):
    return load_g2o(find_data('synthetic_sphere2500_seed42.g2o'),
                    device=device)


def sphere_optimizers(ds, autodiff):
    """The two phases' SparseLMs of sphere2500-huber."""
    kw = dict(SPHERE, kernel=Huber(delta=HUBER_DELTA), autodiff=autodiff)
    return (pgo_optimizer(ds, **kw),
            pgo_optimizer(ds, **dict(kw, cg_iter=SPHERE['polish_cg_iter'])))


@pytest.mark.parametrize('autodiff', [False, True],
                         ids=['closed_form', 'autodiff'])
def test_sphere2500_huber_first_step_matches_anchor(autodiff):
    anchor = load_anchor()
    ds = sphere2500()
    assert instance_checksum(ds) == anchor['instance_checksum']
    opt, _ = sphere_optimizers(ds, autodiff)
    assert opt.route == 'stencil'
    np.testing.assert_allclose(opt.step(), anchor['history'][0],
                               rtol=FIRST)


def test_recorded_port_runs_within_hold():
    """The port's full CPU runs in both Jacobian forms, recorded beside
    the anchor when it was written, are within the tolerances and, as
    the anchor, at pypose's chi2."""
    anchor = load_anchor()
    with open(find_data('ref_anchor_sphere2500.json')) as f:
        target = json.load(f)['final_chi2'] * (1 + 1e-4)
    assert anchor['final_chi2'] <= target
    assert len(anchor['port_cpu_check']) == 2
    for run in anchor['port_cpu_check']:
        assert run['route'] == 'stencil'
        assert len(run['history']) == len(anchor['history'])
        np.testing.assert_allclose(run['history'][0], anchor['history'][0],
                                   rtol=FIRST)
        np.testing.assert_allclose(run['final_chi2'], anchor['final_chi2'],
                                   rtol=FINAL)
        assert run['final_chi2'] <= target


def main():
    import time
    import jax
    from pypose_tpu.optim import kernel as jkernel
    from _anchor import jax_pgo_optimizer, write_anchor
    jax.config.update('jax_platforms', 'cpu')
    ds = sphere2500()
    sched = dict(SPHERE, split_chains=True)
    t0 = time.perf_counter()
    jk = jkernel.Huber(delta=HUBER_DELTA)
    jopt = jax_pgo_optimizer(ds, 'SE3', sched, kernel=jk)
    jopt2 = jax_pgo_optimizer(ds, 'SE3', sched, kernel=jk,
                              cg_iter=SPHERE['polish_cg_iter'])
    initial = float(jopt._chi2(jopt.params, jopt._factor_data()))
    final, hist = two_phase(jopt, jopt2)
    jax_s = time.perf_counter() - t0
    print(f'JAX: {initial} -> {hist}', flush=True)
    runs = []
    for autodiff in (False, True):
        t0 = time.perf_counter()
        opt, opt2 = sphere_optimizers(ds, autodiff)
        pfinal, phist = two_phase(opt, opt2)
        runs.append({'jacobian': 'autodiff' if autodiff else 'closed form',
                     'route': opt.route, 'history': phist,
                     'final_chi2': pfinal,
                     'relative_gap': pfinal / float(final) - 1,
                     'seconds': round(time.perf_counter() - t0, 1)})
        print(f'port CPU ({runs[-1]["jacobian"]}): {phist}', flush=True)
    write_anchor('sphere2500_huber',
                 'tests/test_torch_sphere2500_huber_anchor.py', {
        'problem': 'data/synthetic_sphere2500_seed42.g2o, pgo_factor with '
                   f'Huber(delta={HUBER_DELTA}), float32, built on the CPU',
        'instance_checksum': instance_checksum(ds),
        'schedule': dict(sched, phases='bench.py:199-205 (testing.'
                         'two_phase)'),
        'jax_precond': jopt.precond, 'initial_chi2': initial,
        'history': [float(h) for h in hist], 'final_chi2': float(final),
        'port_cpu_check': runs, 'seconds': {'jax': round(jax_s, 1)},
        'reference': 'pypose_tpu.optim.sparse.SparseLM on the JAX CPU '
                     'backend, factors as bench.py builds sphere2500'})


if __name__ == '__main__':
    main()
