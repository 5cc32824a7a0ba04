"""The bundle-adjustment cells against their anchors.

- ba-anchored: pypose's dense LM on C=16, P=300, O=1200
  (``data/ref_anchor_bal_16_300.json``, final chi2 352.88898; bench.py:
  bench_ba_anchored).  The instance is the JAX package's own
  ``synthetic_bal`` (its pose noise is a ``jax.random`` draw), vendored as
  ``data/jax_instance_bal_16_300.npz``; the port's ``BundleAdjustment``
  (TrustRegion(1e4), no gauge, dense Schur) must reach 352.88898 (+1e-3)
  on the CPU, as the JAX package does.
- ba-trafalgar and ba-large: ``testing.ba_instance`` (the port's
  ``synthetic_bal`` at trafalgar scale, 257/65,132/225,911, and at
  C=2048, P=49,152, six observations a point), and the JAX package's
  ``BundleAdjustment`` run on them (crossed over as numpy, CPU) with
  bench.py's schedules (``testing.BA_SCHEDULES``):
  ``data/jax_anchor_ba_trafalgar.json`` and ``jax_anchor_ba_large.json``.
  An LM step at these sizes takes seconds to tens of seconds on the CPU,
  so the tests here hold the instance checksum and the initial chi2
  (1e-5) and the port's CPU run recorded beside the anchor; the card runs
  the steps (``chip_smoke.py``, with the same tolerances).

Tolerances (first accepted step, final chi2; ``testing.BA_HOLD``).
ba-trafalgar: 3e-4, 1e-3.
The port's CPU run sits 9.0e-5 and 5.7e-6 from the anchor.  The first
step of a dense solve with three refinement passes still carries the
preconditioner's error, and that depends on the last bits of the 3x3
inverses of ill-conditioned point blocks: the JAX package's jitted
``inv3x3`` contracts its products into FMAs and differs from the unfused
form (which the port computes, and which JAX's eager ``inv3x3`` matches
bit for bit) by up to 1.2% of the largest entry, while both are 2.6-3.8%
from float64 there.  The JAX package's own first step moves by up to
8.7e-6 under one-ulp nudges of 10 points, and by 1.3e-5 when its windowed
camera sums are swapped for the gather form.  ba-large: 1e-3, 1e-3.  The
JAX package's own spread under five nudges is 1.1e-6 (first accepted) and
2.2e-7 (final), far inside; the port's CPU run sits 4.6e-7 and 0 from the
anchor.

Write them (JAX, then the port, on the CPU):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_ba_anchor.py \\
        [instance] [ba_trafalgar] [ba_large]

and ``... --spread ba_large N`` (or ``ba_trafalgar``) prints the JAX
package's own first accepted and final chi2 under N one-ulp nudges of the
initial points, which sets the tolerances.
"""

import json
import os

import numpy as np
import pytest

from pypose_tpu_torch.datasets import find_data
from pypose_tpu_torch.testing import (BA_HOLD, BA_PROBLEMS, BA_SCHEDULES,
                                      ba_instance, ba_optimizer, bal_checksum)

REF = 'ref_anchor_bal_16_300.json'
INSTANCE = 'jax_instance_bal_16_300.npz'


def _json(name):
    with open(find_data(name)) as f:
        return json.load(f)


def _optimize(opt, name):
    sched = BA_SCHEDULES[name]
    return opt.optimize(steps=sched['steps'], patience=sched['patience'],
                        decreasing=sched['decreasing'])


def test_anchored_reaches_pypose_chi2():
    """The port on the JAX package's instance reaches pypose's chi2 within
    1e-3, as bench.py:bench_ba_anchored asks of the JAX package."""
    ref = _json(REF)
    ds = ba_instance('ba-anchored', device='cpu')
    assert bal_checksum(ds)['n_obs'] == ref['n_obs']
    opt = ba_optimizer(ds, 'ba-anchored')
    assert opt._use_dense_schur
    np.testing.assert_allclose(float(opt._chi2(ds['poses'].tensor(),
                                               ds['points'])),
                               ref['initial_chi2'], rtol=1e-5)
    _optimize(opt, 'ba-anchored')
    target = ref['final_chi2'] * (1 + 1e-3)
    assert any(h <= target for h in opt.history), opt.history


@pytest.mark.parametrize('name', ['ba-trafalgar', 'ba-large'])
def test_instance_and_initial_chi2_match_anchor(name):
    anchor = _json(f'jax_anchor_{name.replace("-", "_")}.json')
    ds = ba_instance(name, device='cpu')
    got, want = bal_checksum(ds), anchor['instance_checksum']
    assert got['n_obs'] == want['n_obs']
    for key in ('poses_abs_sum', 'points_abs_sum', 'pixels_abs_sum'):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9,
                                   err_msg=key)
    opt = ba_optimizer(ds, name)
    assert opt._use_dense_schur == (anchor['route'] == 'dense')
    assert (opt._cam_win is not None) == anchor['cam_windows']
    np.testing.assert_allclose(
        float(opt._chi2(ds['poses'].tensor(), ds['points'])),
        anchor['initial_chi2'], rtol=1e-5)


@pytest.mark.parametrize('name', ['ba-trafalgar', 'ba-large'])
def test_recorded_port_run_within_hold(name):
    anchor = _json(f'jax_anchor_{name.replace("-", "_")}.json')
    run = anchor['port_cpu_check']
    first, final = BA_HOLD[name]
    np.testing.assert_allclose(first_accepted(run['history'],
                                              anchor['initial_chi2']),
                               first_accepted(anchor['history'],
                                              anchor['initial_chi2']),
                               rtol=first)
    np.testing.assert_allclose(run['history'][-1], anchor['final_chi2'],
                               rtol=final)


def first_accepted(history, initial):
    """The first chi2 of ``history`` below ``initial``: the first step
    that was taken."""
    return next(h for h in history if h < initial)


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------

def write_instance():
    """data/jax_instance_bal_16_300.npz: the JAX package's synthetic_bal
    with the pypose anchor's arguments, float32."""
    from pypose_tpu.datasets import synthetic_bal
    ref = _json(REF)
    ds = synthetic_bal(n_cams=ref['n_cams'], n_points=ref['n_points'],
                       obs_per_point=ref['obs_per_point'],
                       pose_noise=tuple(ref['pose_noise']),
                       point_noise=ref['point_noise'],
                       pixel_noise=ref['pixel_noise'], seed=ref['seed'])
    arrays = {k: np.asarray(v.tensor() if hasattr(v, 'tensor') else v)
              for k, v in ds.items()}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    np.savez_compressed(os.path.join(repo, 'data', INSTANCE), **arrays)
    print({k: (a.dtype, a.shape) for k, a in arrays.items()})


def jax_ba(ds, name, points=None):
    """The JAX package's BundleAdjustment of a cell on a port problem,
    crossed over as numpy; ``points`` replaces the initial points."""
    import jax.numpy as jnp
    import pypose_tpu as jpp
    from pypose_tpu.optim.ba import BundleAdjustment
    from pypose_tpu.optim.strategy import TrustRegion

    def np_(x):
        return (x.tensor() if hasattr(x, 'tensor') else x).cpu().numpy()
    sched = BA_SCHEDULES[name]
    kw = {k: v for k, v in sched.items()
          if k in ('fix_first_pose', 'cg_iter', 'cg_tol')}
    if 'radius' in sched:
        kw['strategy'] = TrustRegion(radius=sched['radius'])
    pts = np_(ds['points']) if points is None else points
    return BundleAdjustment(
        jpp.SE3(jnp.asarray(np_(ds['poses']))), jnp.asarray(pts),
        jnp.asarray(np_(ds['cam_idx']).astype(np.int32)),
        jnp.asarray(np_(ds['pt_idx']).astype(np.int32)),
        jnp.asarray(np_(ds['pixels'])), jnp.asarray(np_(ds['cameras'])),
        **kw)


def write_cell(name):
    import time
    from _anchor import write_anchor
    from pypose_tpu_torch.optim import ba as ba_mod, solver
    ds = ba_instance(name, device='cpu')
    t0 = time.perf_counter()
    jopt = jax_ba(ds, name)
    initial = float(jopt._chi2(jopt.poses.tensor(), jopt.points))
    final = float(_optimize(jopt, name))
    jax_s = time.perf_counter() - t0
    print(f'{name} JAX ({"dense" if jopt._use_dense_schur else "cg"}): '
          f'{initial} -> {jopt.history} in {jax_s:.1f} s', flush=True)
    t0 = time.perf_counter()
    reads, cg_reads = ba_mod.HOST_READS, solver.CG_HOST_READS
    opt = ba_optimizer(ds, name)
    pfinal = _optimize(opt, name)
    print(f'{name} port CPU: {opt.history}, rejections {opt.rejections}, '
          f'CG iterations {opt.cg_iterations}', flush=True)
    write_anchor(name.replace('-', '_'), 'tests/test_torch_ba_anchor.py', {
        'problem': f'pypose_tpu_torch.testing.ba_instance({name!r}): '
                   f'synthetic_bal(**{BA_PROBLEMS[name]}), float32, built '
                   'on the CPU',
        'instance_checksum': bal_checksum(ds),
        'schedule': BA_SCHEDULES[name],
        'route': 'dense' if jopt._use_dense_schur else 'cg',
        'cam_windows': jopt._cam_win is not None,
        'initial_chi2': initial, 'history': jopt.history,
        'final_chi2': final,
        'port_cpu_check': {
            'route': 'dense' if opt._use_dense_schur else 'cg',
            'history': opt.history, 'rejections': opt.rejections,
            'cg_iterations': opt.cg_iterations,
            'host_reads': ba_mod.HOST_READS - reads,
            'cg_host_reads': solver.CG_HOST_READS - cg_reads,
            'relative_gap': pfinal / final - 1,
            'seconds': round(time.perf_counter() - t0, 1)},
        'seconds': {'jax': round(jax_s, 1)},
        'reference': 'pypose_tpu.optim.ba.BundleAdjustment on the JAX CPU '
                     'backend, arguments as bench.py builds them'})


def _nudged_points(ds, seed):
    """The initial points of ``ds`` with 10 points (drawn from
    ``np.random.default_rng(seed)``) moved up by one float32 ulp."""
    x = ds['points'].numpy().copy()
    idx = np.random.default_rng(seed).choice(len(x), 10, replace=False)
    x[idx] = np.nextafter(x[idx], np.float32(np.inf))
    return x


def spread(name, n):
    """The JAX package's first accepted and final chi2 of a cell on n
    one-ulp nudges of the initial points (seeds 1..n), relative to the
    anchor's."""
    anchor = _json(f'jax_anchor_{name.replace("-", "_")}.json')
    first = first_accepted(anchor['history'], anchor['initial_chi2'])
    ds = ba_instance(name, device='cpu')
    for seed in range(1, n + 1):
        jopt = jax_ba(ds, name, points=_nudged_points(ds, seed))
        final = float(_optimize(jopt, name))
        f = first_accepted(jopt.history, anchor['initial_chi2'])
        print(f'{name} nudge {seed}: JAX first accepted {f:.7g} '
              f'({f / first - 1:+.3e}), final {final:.7g} '
              f'({final / anchor["final_chi2"] - 1:+.3e} of the anchor); '
              f'history {jopt.history}', flush=True)


def main():
    import sys
    import jax
    jax.config.update('jax_platforms', 'cpu')
    args = sys.argv[1:] or ['instance', 'ba_trafalgar', 'ba_large']
    if args[0] == '--spread':
        return spread(args[1].replace('_', '-'), int(args[2]))
    for what in args:
        if what == 'instance':
            write_instance()
        else:
            write_cell(what.replace('_', '-'))


if __name__ == '__main__':
    main()
