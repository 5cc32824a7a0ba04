"""The JAX anchor of the reprojection pose graph (reproj-pgo).

``pypose_tpu_torch.testing.reproj_pgo_instance()``: ``examples/
reproj_pgo.py``'s factor graph at 2,500 SE3 poses on a circle, 7,500 R^3
landmarks and 6 observations a pose, the example's noise levels, from
numpy seed 0; ``testing.reproj_pgo_optimizer``: a ``pgo_factor`` over the
odometry and a residual-only factor ``X.Act(lm) - meas`` (Jacobian by
autodiff), pose 0 fixed, TrustRegion(1e6), cg_iter 150, cg_tol 1e-7,
``optimize(steps=10, decreasing=1e-4, patience=2)``.  Two variable groups:
the 'einsum' route with the generic gather matvec, no kernel.  The target
is what the JAX package's ``SparseLM`` computes on the same arrays,
``data/jax_anchor_reproj_pgo.json``.  Write it (JAX, then the port, on the
CPU; ~1 minute):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_reproj_pgo_anchor.py

Tolerances, float32: the first step within 1e-4 (one LM step at full size
on the CPU), the port's recorded CPU run first step 1e-4 and final 1e-3
(measured on the CPU: 0 and 9.3e-8).
"""

import json

import numpy as np

import pypose_tpu_torch as ppt
from pypose_tpu_torch.datasets import find_data
from pypose_tpu_torch.testing import reproj_pgo_instance, reproj_pgo_optimizer

REPROJ = dict(radius=1e6, cg_iter=150, cg_tol=1e-7, steps=10,
              decreasing=1e-4, patience=2)
FIRST, FINAL = 1e-4, 1e-3


def load_anchor():
    with open(find_data('jax_anchor_reproj_pgo.json')) as f:
        return json.load(f)


def reproj_checksum(ds):
    """float64 sums of |x| of the instance's initial values and
    measurements."""
    return {k: float((ds[k].tensor() if isinstance(ds[k], ppt.LieTensor)
                      else ds[k]).double().abs().sum())
            for k in ('poses', 'landmarks', 'odometry', 'meas')}


def test_reproj_pgo_first_step_matches_anchor():
    anchor = load_anchor()
    ds = reproj_pgo_instance(device='cpu')
    got, want = reproj_checksum(ds), anchor['instance_checksum']
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)
    opt = reproj_pgo_optimizer(ds, **REPROJ)
    assert opt.route == 'einsum'
    np.testing.assert_allclose(opt.step(), anchor['history'][0],
                               rtol=FIRST)


def test_recorded_port_run_within_hold():
    anchor = load_anchor()
    run = anchor['port_cpu_check']
    assert run['route'] == 'einsum'
    assert len(run['history']) == len(anchor['history'])
    np.testing.assert_allclose(run['history'][0], anchor['history'][0],
                               rtol=FIRST)
    np.testing.assert_allclose(run['final_chi2'], anchor['final_chi2'],
                               rtol=FINAL)


def jax_reproj_optimizer(ds):
    """The JAX package's SparseLM on the port's reproj-pgo instance,
    built as examples/reproj_pgo.py builds it."""
    import jax.numpy as jnp
    import pypose_tpu as jpp
    from pypose_tpu.optim import sparse as jsparse

    def np_(x):
        return (x.tensor() if isinstance(x, ppt.LieTensor) else x).numpy()

    def obs_residual(values, meas):
        return values['poses'][0].Act(values['landmarks'][0]) - meas

    odo = jsparse.pgo_factor(jnp.asarray(np_(ds['edges']).astype('i4')),
                             jpp.SE3(jnp.asarray(np_(ds['odometry']))))
    obs = jsparse.Factor(
        obs_residual,
        indices={'poses': jnp.asarray(np_(ds['obs_pose']).astype('i4'))[
            :, None],
                 'landmarks': jnp.asarray(np_(ds['obs_landmark']).astype(
                     'i4'))[:, None]},
        consts=jnp.asarray(np_(ds['meas'])))
    N, L = ds['poses'].shape[0], ds['landmarks'].shape[0]
    return jsparse.SparseLM(
        {'poses': jpp.SE3(jnp.asarray(np_(ds['poses']))),
         'landmarks': jnp.asarray(np_(ds['landmarks']))}, [odo, obs],
        strategy=jsparse.TrustRegion(radius=REPROJ['radius']),
        fixed={'poses': jnp.zeros(N, bool).at[0].set(True),
               'landmarks': jnp.zeros(L, bool)},
        cg_iter=REPROJ['cg_iter'], cg_tol=REPROJ['cg_tol'])


def main():
    import time
    import jax
    from _anchor import write_anchor
    jax.config.update('jax_platforms', 'cpu')
    ds = reproj_pgo_instance(device='cpu')
    t0 = time.perf_counter()
    jopt = jax_reproj_optimizer(ds)
    initial = float(jopt._chi2(jopt.params, jopt._factor_data()))
    final = float(jopt.optimize(steps=REPROJ['steps'],
                                decreasing=REPROJ['decreasing'],
                                patience=REPROJ['patience']))
    hist = [float(h) for h in jopt.history]
    jax_s = time.perf_counter() - t0
    print(f'JAX: {initial} -> {hist}', flush=True)
    t0 = time.perf_counter()
    opt = reproj_pgo_optimizer(ds, **REPROJ)
    pfinal = opt.optimize(steps=REPROJ['steps'],
                          decreasing=REPROJ['decreasing'],
                          patience=REPROJ['patience'])
    print(f'port CPU: {opt.history}', flush=True)
    write_anchor('reproj_pgo', 'tests/test_torch_reproj_pgo_anchor.py', {
        'problem': 'pypose_tpu_torch.testing.reproj_pgo_instance() '
                   '(examples/reproj_pgo.py at 2,500 poses, 7,500 '
                   'landmarks, 6 observations a pose), float32, built on '
                   'the CPU',
        'instance_checksum': reproj_checksum(ds), 'schedule': REPROJ,
        'jax_precond': jopt.precond, 'initial_chi2': initial,
        'history': hist, 'final_chi2': final,
        'port_cpu_check': {'route': opt.route, 'history': opt.history,
                           'final_chi2': pfinal,
                           'relative_gap': pfinal / final - 1,
                           'cg_iterations': opt.cg_iterations,
                           'seconds': round(time.perf_counter() - t0, 1)},
        'seconds': {'jax': round(jax_s, 1)},
        'reference': 'pypose_tpu.optim.sparse.SparseLM on the JAX CPU '
                     'backend, factors as examples/reproj_pgo.py builds '
                     'them'})


if __name__ == '__main__':
    main()
