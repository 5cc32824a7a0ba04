"""``optim/ba.py:BundleAdjustment`` against the JAX package's, on the same
numpy arrays (the port's ``synthetic_bal`` crossed over), and the JAX
package's own BA tests (tests/optim/test_ba.py) mirrored on the port.

Tolerances, measured on the CPU: the tables (sort permutation, incidence,
windows, route) are equal; one LM step's chi2 within 2e-5 (Schur-CG) or
5e-5 (dense) in float32, 1e-9 (Schur-CG) or 1e-6 (dense: its Gram runs on
bf16-rounded operands in float64 too) in float64, and its poses and
points within 5e-4 (float32), 1e-8 or 1e-5 (float64) of the largest
update; the optimize histories at 16/300 within 1e-4 entry by entry
(dense) and 1e-3 (Schur-CG) while both run (at the floor a rejection,
and with it the stop, is rounding noise).  The JAX package's jitted 3x3
inverses contract their products into FMAs (its eager ones match the
port's bit for bit), which is what moves the float32 numbers; a dense
step with three refinement passes keeps its preconditioner's error and
so those bits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import pypose_tpu as jpp
from pypose_tpu.optim import ba as jba
from pypose_tpu.optim.kernel import Huber as JHuber
from pypose_tpu.optim import strategy as jstrategy
from pypose_tpu.datasets import synthetic_bal as jax_synthetic_bal
import pypose_tpu_torch as ppt
from pypose_tpu_torch.datasets import synthetic_bal
from pypose_tpu_torch.optim import ba
from pypose_tpu_torch.optim import strategy
from pypose_tpu_torch.optim.ba import BundleAdjustment, reproj_residual_bal
from pypose_tpu_torch.optim.kernel import Huber
from pypose_tpu_torch.testing import ba_instance, ba_optimizer
from pypose_tpu_torch.testing import cap_threads

cap_threads()

# tests/optim/test_ba.py's problems: (C, P, obs per point, seed, pose
# noise, point noise)
SHAPES = [(8, 150, 4, 2, (0.05, 0.02), 0.05), (6, 100, 4, 3, (0., 0.), 0.),
          (8, 200, 4, 3, (0.05, 0.02), 0.05), (8, 300, 4, 1, (0.05, 0.02),
                                                0.05),
          (24, 400, 4, 2, (0.1, 0.05), 0.2), (6, 40, 3, 0, (0.05, 0.02),
                                              0.05),
          (48, 2100, 5, 3, (0.1, 0.02), 0.1), (8, 100, 3, 0, (0.05, 0.02),
                                               0.05)]


def _np(x):
    x = x.tensor() if hasattr(x, 'tensor') else x
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def problem(C, P, k, seed, pose_noise=(0.05, 0.02), point_noise=0.05,
            dtype=torch.float32, **kw):
    return synthetic_bal(C, P, k, seed=seed, pose_noise=pose_noise,
                         point_noise=point_noise, dtype=dtype, device='cpu',
                         **kw)


def jax_problem(C, P, k, seed, pose_noise=(0.05, 0.02), point_noise=0.05,
                **kw):
    """The JAX package's own synthetic_bal problem (its tests' instance,
    pose noise from jax.random), as port tensors."""
    ds = jax_synthetic_bal(n_cams=C, n_points=P, obs_per_point=k,
                           seed=seed, pose_noise=pose_noise,
                           point_noise=point_noise, **kw)
    out = {k_: torch.as_tensor(np.array(_np(v))) for k_, v in ds.items()}
    for k_ in ('poses', 'gt_poses'):
        out[k_] = ppt.SE3(out[k_])
    return out


_JAX_STRATEGIES = {strategy.TrustRegion: jstrategy.TrustRegion,
                   strategy.Adaptive: jstrategy.Adaptive,
                   strategy.Constant: jstrategy.Constant}


def pair(ds, pixels=None, **kw):
    """(JAX BundleAdjustment, port BundleAdjustment) on the same arrays."""
    pixels = ds['pixels'] if pixels is None else pixels
    jkw = dict(kw)
    if 'strategy' in kw:
        s = kw['strategy']
        args = {k: v for k, v in vars(s).items()}
        if isinstance(s, strategy.TrustRegion):
            args['down'] = args.pop('down0')
        jkw['strategy'] = _JAX_STRATEGIES[type(s)](**args)
    if 'kernel' in kw:
        jkw['kernel'] = JHuber(delta=kw['kernel'].delta)
    if kw.get('residual') is not None:
        jkw['residual'] = _jax_user_residual
    j = jba.BundleAdjustment(
        jpp.SE3(jnp.asarray(_np(ds['poses']))), jnp.asarray(_np(ds['points'])),
        jnp.asarray(_np(ds['cam_idx']).astype(np.int32)),
        jnp.asarray(_np(ds['pt_idx']).astype(np.int32)),
        jnp.asarray(_np(pixels)), jnp.asarray(_np(ds['cameras'])), **jkw)
    t = BundleAdjustment(ds['poses'], ds['points'], ds['cam_idx'],
                         ds['pt_idx'], pixels, ds['cameras'], **kw)
    return j, t


def _jax_user_residual(pose, point, camera, pixel):
    return jba.reproj_residual_bal(pose, point, camera, pixel)


def user_residual(pose, point, camera, pixel):
    """A copy of ``reproj_residual_bal``: not the same function, so
    ``_r_jac`` takes its Jacobian by autodiff."""
    Xc = pose.Act(point)
    p = -Xc[..., :2] / Xc[..., 2:3]
    r2 = torch.sum(p * p, -1, keepdim=True)
    distortion = 1.0 + camera[..., 1:2] * r2 + camera[..., 2:3] * r2 * r2
    return camera[..., 0:1] * distortion * p - pixel


@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: f'{s[0]}x{s[1]}')
def test_tables_and_route_match_jax(shape):
    ds = problem(*shape)
    j, t = pair(ds)
    np.testing.assert_array_equal(t._obs_perm, j._obs_perm)
    for key in ('cam_idx', 'pt_idx', 'pixels', 'cameras'):
        np.testing.assert_array_equal(_np(getattr(t, key)),
                                      _np(getattr(j, key)), err_msg=key)
    for side in ('_pt_inc', '_cam_inc'):
        for a, b in zip(getattr(t, side), getattr(j, side)):
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=side)
    assert (t._cam_win is None) == (j._cam_win is None)
    if t._cam_win is not None:
        for key in ('li', 'widx', 'wvalid'):
            np.testing.assert_array_equal(_np(t._cam_win[key]),
                                          _np(j._cam_win[key]), err_msg=key)
    assert t._use_dense_schur == j._use_dense_schur
    old = (jba.BundleAdjustment.DENSE_SCHUR_MAX_C,
           BundleAdjustment.DENSE_SCHUR_MAX_C)
    try:
        jba.BundleAdjustment.DENSE_SCHUR_MAX_C = 16
        BundleAdjustment.DENSE_SCHUR_MAX_C = 16
        j2, t2 = pair(ds)
        assert t2._use_dense_schur == j2._use_dense_schur == (shape[0] <= 16)
    finally:
        jba.BundleAdjustment.DENSE_SCHUR_MAX_C, \
            BundleAdjustment.DENSE_SCHUR_MAX_C = old


def test_windowed_cam_ops_match_gather_and_jax():
    """The windowed broadcast is exact; the windowed sums agree with the
    gather form and with the JAX package's windowed sums (2e-5), and
    repeat their bits."""
    ds = problem(48, 2100, 5, 3, (0.1, 0.02), 0.1)
    j, t = pair(ds, fix_first_pose=True, schur='cg')
    assert t._cam_win is not None
    assert np.all(np.diff(_np(t.cam_idx)) >= 0)
    obs, jobs = t._obs_data(), j._obs_data()
    nowin = dict(obs, cam_win=None)
    rng = np.random.default_rng(0)
    O = ds['pixels'].shape[0]
    x = rng.normal(size=(t.C, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        t._bcast_cams(obs, torch.as_tensor(x)).numpy(),
        x[_np(t.cam_idx)])
    for shape in ((O, 6), (O, 6, 6)):
        c = rng.normal(size=shape).astype(np.float32)
        got = t._acc_cams(obs, torch.as_tensor(c))
        np.testing.assert_allclose(
            got.numpy(), t._acc_cams(nowin, torch.as_tensor(c)).numpy(),
            rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(j._acc_cams(jobs, jnp.asarray(c))),
            rtol=2e-5, atol=2e-5)
        assert torch.equal(got, t._acc_cams(obs, torch.as_tensor(c)))
    # one LM step, windowed against gather
    strat = t.strategy.init(t.dtype)
    T = ds['poses'].tensor()
    out_w = t._core(T, t.points, strat, obs)
    out_g = t._core(T, t.points, strat, nowin)
    np.testing.assert_allclose(float(out_w[2]), float(out_g[2]), rtol=1e-4)


def test_scatter_fallbacks_match_gather(monkeypatch):
    """Past the degree caps the sums are segment sums over the
    observations sorted by row (the JAX package scatters there, and never
    sets its camera table once a point passes its cap)."""
    ds = problem(8, 300, 4, 1)
    t = BundleAdjustment(ds['poses'], ds['points'], ds['cam_idx'],
                         ds['pt_idx'], ds['pixels'], ds['cameras'],
                         fix_first_pose=True, schur='cg', cg_iter=20)
    monkeypatch.setattr(BundleAdjustment, 'MAX_POINT_DEGREE', 2)
    monkeypatch.setattr(BundleAdjustment, 'MAX_CAM_DEGREE', 2)
    s = BundleAdjustment(ds['poses'], ds['points'], ds['cam_idx'],
                         ds['pt_idx'], ds['pixels'], ds['cameras'],
                         fix_first_pose=True, schur='auto', cg_iter=20)
    assert s._pt_inc is None and s._cam_inc is None
    assert not s._use_dense_schur
    c = torch.as_tensor(np.random.default_rng(1).normal(
        size=(ds['pixels'].shape[0], 3, 3)).astype(np.float32))
    for name in ('_acc_cams', '_acc_points'):
        np.testing.assert_allclose(
            getattr(s, name)(s._obs_data(), c).numpy(),
            getattr(t, name)(t._obs_data(), c).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.step(), t.step(), rtol=1e-5)


def _core_pair(j, t, ds):
    jout = jax.jit(j._core)(
        jnp.asarray(_np(ds['poses'])), jnp.asarray(_np(ds['points'])),
        j.strategy.init(jnp.asarray(_np(ds['points'])).dtype),
        j._obs_data())
    tout = t._core(ds['poses'].tensor(), ds['points'],
                   t.strategy.init(t.dtype), t._obs_data())
    return jout, tout


@pytest.mark.parametrize('schur', ['dense', 'cg'])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_core_step_matches_jax(schur, dtype):
    """One LM step (the CG run to its 30-iteration cap): chi2 before and
    after, the rejections, the damping, and the poses and points."""
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    ds = problem(8, 300, 4, 1, (0.1, 0.04), 0.1, dtype=tdt)
    with jax.enable_x64(dtype == np.float64):
        j, t = pair(ds, fix_first_pose=True, schur=schur, cg_iter=30,
                    cg_tol=1e-30)
        (jT, jX, jloss, jlast, jstrat, jcount), tout = _core_pair(j, t, ds)
        tT, tX, tloss, tlast, tstrat, tcount, its = tout
        # float64 runs the dense Gram on bf16-rounded operands too
        chi_tol, x_tol = {(np.float32, 'dense'): (5e-5, 5e-4),
                          (np.float32, 'cg'): (2e-5, 5e-4),
                          (np.float64, 'dense'): (1e-6, 1e-5),
                          (np.float64, 'cg'): (1e-9, 1e-8)}[dtype, schur]
        np.testing.assert_allclose(float(tlast), float(jlast), rtol=chi_tol)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=chi_tol)
        assert float(tloss) < float(tlast)
        assert tcount == int(jcount)
        np.testing.assert_allclose(float(tstrat['damping']),
                                   float(jstrat['damping']), rtol=1e-6)
        if schur == 'cg':
            assert its == [30] * (tcount + 1)
        for got, want, start in ((tT, jT, ds['poses']), (tX, jX,
                                                         ds['points'])):
            step = np.abs(np.asarray(want) - _np(start)).max()
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=x_tol * step)


@pytest.mark.parametrize('schur', ['dense', 'cg'])
def test_optimize_history_matches_jax(schur):
    """The anchored problem (16/300, the JAX instance), both routes, eight
    steps."""
    ds = ba_instance('ba-anchored', device='cpu')
    j, t = pair(ds, fix_first_pose=True, schur=schur, cg_iter=100,
                cg_tol=1e-6)
    jl = j.optimize(steps=8, patience=8, decreasing=1e-6)
    tl = t.optimize(steps=8, patience=8, decreasing=1e-6)
    tol = 1e-4 if schur == 'dense' else 1e-3
    # at the floor a rejection is rounding noise, and with it the stop
    n = min(len(t.history), len(j.history))
    assert n >= 4
    np.testing.assert_allclose(t.history[:n], j.history[:n], rtol=tol)
    np.testing.assert_allclose(tl, jl, rtol=tol)
    assert all(isinstance(h, float) for h in t.history)
    assert t.history == [float(np.float32(h)) for h in t.history]


@pytest.mark.parametrize('make', [
    lambda: strategy.Constant(damping=1e-4),
    lambda: strategy.Adaptive(damping=1e-3),
    lambda: strategy.TrustRegion(radius=1e3)], ids=['Constant', 'Adaptive',
                                                    'TrustRegion'])
def test_strategies_in_ba_match_jax(make):
    ds = problem(8, 200, 4, 3, (0.1, 0.04), 0.1)
    j, t = pair(ds, fix_first_pose=True, strategy=make(), schur='dense')
    jh = [j.step() for _ in range(4)]
    th = [t.step() for _ in range(4)]
    np.testing.assert_allclose(th, jh, rtol=1e-4)
    for k in t.strategy_state:
        np.testing.assert_allclose(float(t.strategy_state[k]),
                                   float(j.strategy_state[k]), rtol=1e-6)


def test_adaptive_update_matches_jax():
    """Adaptive.update and _quality on a dense (J, D, R), including the
    guard: a non-positive predicted reduction scores -1."""
    rng = np.random.default_rng(2)
    J, D, R = (rng.normal(size=s).astype(np.float32)
               for s in ((6, 4), (4, 1), (6, 1)))
    s, js = strategy.Adaptive(damping=1e-2), jstrategy.Adaptive(damping=1e-2)
    for last, loss in ((5.0, 1.0), (5.0, 4.99), (1.0, 5.0)):
        for sign in (1.0, -1.0):
            got = s.update(s.init(), last, loss, torch.as_tensor(J),
                           torch.as_tensor(sign * D), torch.as_tensor(R))
            want = js.update(js.init(), last, loss, jnp.asarray(J),
                             jnp.asarray(sign * D), jnp.asarray(R))
            np.testing.assert_allclose(float(got['damping']),
                                       float(want['damping']), rtol=1e-6)
            np.testing.assert_allclose(
                float(strategy._quality(last, loss, torch.as_tensor(J),
                                        torch.as_tensor(sign * D),
                                        torch.as_tensor(R))),
                float(jstrategy._quality(last, loss, jnp.asarray(J),
                                         jnp.asarray(sign * D),
                                         jnp.asarray(R))), rtol=1e-5)
    c = strategy.Constant(3e-3)
    assert c.update(c.init(), 1., 0., None, None, None)['damping'] == \
        c.init()['damping']


def test_non_pd_factor_rejects_the_step(monkeypatch):
    """No refinement (so no boost), no gauge and damping 1e-12: the
    bf16-formed S of the gauge-free problem is not positive definite.
    The port's Cholesky reports it (``cholesky_ex``), the step is NaN and
    not taken, and the step ends without an exception, as the JAX
    package's NaN factor ends it."""
    ds = problem(6, 100, 3, 3)
    kw = dict(fix_first_pose=False, schur='dense', schur_refine=0,
              strategy=strategy.Constant(1e-12))
    j, t = pair(ds, **kw)
    infos = []
    chol = torch.linalg.cholesky_ex

    def spy(S):
        L, info = chol(S)
        infos.append(int(info))
        return L, info
    monkeypatch.setattr(torch.linalg, 'cholesky_ex', spy)
    jloss, tloss = j.step(), t.step()
    assert infos and infos[0] > 0
    assert tloss == t.last and t.reject_count == 0
    assert jloss == j.last and j.reject_count == 0
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert torch.equal(t.poses.tensor(), ds['poses'].tensor())
    assert torch.equal(t.points, ds['points'])


def test_autodiff_branch_matches_closed_form_and_jax():
    """A user residual (a copy of the BAL one) takes vmap(jacrev) at
    eps = 0: its Jacobians equal the closed form (float64 1e-10), and one
    LM step with a Huber kernel equals the JAX package's vmap(jacrev)
    branch (float32 2e-5)."""
    ds = problem(6, 80, 3, 4, dtype=torch.float64)
    auto = BundleAdjustment(ds['poses'], ds['points'], ds['cam_idx'],
                            ds['pt_idx'], ds['pixels'], ds['cameras'],
                            residual=user_residual)
    closed = BundleAdjustment(ds['poses'], ds['points'], ds['cam_idx'],
                              ds['pt_idx'], ds['pixels'], ds['cameras'])
    obs = closed._obs_data()
    T = ds['poses'].tensor()
    for a, b in zip(auto._r_jac(obs, T, ds['points']),
                    closed._r_jac(obs, T, ds['points'])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-10 * float(b.abs().max()))
    ds32 = problem(8, 150, 4, 4)
    pixels = ds32['pixels'].clone()
    pixels[::50] += 100.0
    j, t = pair(ds32, pixels=pixels, residual=user_residual,
                kernel=Huber(delta=5.0), fix_first_pose=True)
    np.testing.assert_allclose(t.step(), j.step(), rtol=2e-5)
    np.testing.assert_allclose(t.last, j.last, rtol=1e-6)


def test_float64_steps_match_jax():
    ds = problem(8, 200, 4, 3, (0.1, 0.04), 0.1, dtype=torch.float64)
    with jax.enable_x64():
        for schur in ('dense', 'cg'):
            j, t = pair(ds, fix_first_pose=True, schur=schur, cg_iter=200,
                        cg_tol=1e-12)
            th = [t.step() for _ in range(3)]
            jh = [j.step() for _ in range(3)]
            assert t.points.dtype == torch.float64
            np.testing.assert_allclose(th, jh, rtol=1e-6)


# ---------------------------------------------------------------------------
# tests/optim/test_ba.py, mirrored on the JAX package's own problems
# ---------------------------------------------------------------------------

def _pose_err(ba_, ds):
    return float((ba_.poses.Inv() @ ds['gt_poses']).Log().tensor()
                 .abs().mean())


def test_ba_converges():
    ds = jax_problem(8, 150, 4, 2)
    t = BundleAdjustment(ds['poses'], ds['points'], ds['cam_idx'],
                         ds['pt_idx'], ds['pixels'], ds['cameras'],
                         fix_first_pose=True, cg_iter=40, cg_tol=1e-6)
    first = None
    for _ in range(6):
        loss = t.step()
        first = t.last if first is None else first
    assert loss < first
    assert _pose_err(t, ds) < 0.02


def test_ba_perfect_data_zero_residual():
    ds = jax_problem(6, 100, 4, 3, (0., 0.), 0., pixel_noise=0.0)
    t = BundleAdjustment(ds['gt_poses'], ds['gt_points'], ds['cam_idx'],
                         ds['pt_idx'], ds['pixels'], ds['cameras'])
    loss = t.step()
    assert t.last < 1e-4
    assert loss <= t.last + 1e-6


def test_ba_with_robust_kernel():
    ds = jax_problem(8, 150, 4, 4)
    pixels = ds['pixels'].clone()
    pixels[::50] += 100.0
    t = BundleAdjustment(ds['poses'], ds['points'], ds['cam_idx'],
                         ds['pt_idx'], pixels, ds['cameras'],
                         kernel=Huber(delta=5.0), fix_first_pose=True,
                         cg_iter=40)
    for _ in range(6):
        t.step()
    assert _pose_err(t, ds) < 0.05


def test_bal_residual_matches_projection():
    ds = jax_problem(4, 50, 4, 5, (0., 0.), 0., pixel_noise=0.0)
    r = reproj_residual_bal(ds['gt_poses'][ds['cam_idx']],
                            ds['gt_points'][ds['pt_idx']],
                            ds['cameras'][ds['cam_idx']], ds['pixels'])
    np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-3)


def test_ba_optimize_matches_steps():
    ds = jax_problem(8, 200, 4, 3)

    def mk():
        return BundleAdjustment(ds['poses'], ds['points'], ds['cam_idx'],
                                ds['pt_idx'], ds['pixels'], ds['cameras'],
                                fix_first_pose=True, cg_iter=30)
    b1, b2 = mk(), mk()
    for _ in range(6):
        l1 = b1.step()
    l2 = b2.optimize(steps=6, patience=6, decreasing=0.0)
    assert len(b2.history) >= 1
    assert abs(l1 - l2) / max(abs(l1), 1e-12) < 1e-3
    assert torch.allclose(b1.points, b2.points, atol=0.1)


def test_ba_optimize_plateau_stops_early():
    ds = jax_problem(8, 200, 4, 4)
    t = BundleAdjustment(ds['poses'], ds['points'], ds['cam_idx'],
                         ds['pt_idx'], ds['pixels'], ds['cameras'],
                         fix_first_pose=True, cg_iter=30)
    t.optimize(steps=30, patience=2, decreasing=1e-3)
    assert len(t.history) < 30


def test_ba_dense_schur_matches_cg():
    ds = jax_problem(8, 300, 4, 1)

    def mk(schur):
        return BundleAdjustment(ds['poses'], ds['points'], ds['cam_idx'],
                                ds['pt_idx'], ds['pixels'], ds['cameras'],
                                fix_first_pose=True, cg_iter=200,
                                cg_tol=1e-10, schur=schur)
    bd, bc = mk('dense'), mk('cg')
    assert bd._use_dense_schur and not bc._use_dense_schur
    ld = bd.optimize(steps=6, patience=6, decreasing=1e-6)
    lc = bc.optimize(steps=6, patience=6, decreasing=1e-6)
    np.testing.assert_allclose(ld, lc, rtol=1e-3)
    err = (bd.poses.Inv() @ bc.poses).Log().tensor()
    assert float(err.abs().max()) < 1e-1


def test_ba_auto_routed_cg_converges(monkeypatch):
    ds = jax_problem(24, 400, 4, 2, (0.1, 0.05), 0.2)
    monkeypatch.setattr(BundleAdjustment, 'DENSE_SCHUR_MAX_C', 16)
    t = BundleAdjustment(ds['poses'], ds['points'], ds['cam_idx'],
                         ds['pt_idx'], ds['pixels'], ds['cameras'],
                         fix_first_pose=True, cg_iter=100, cg_tol=1e-8)
    assert not t._use_dense_schur
    l0 = float(t._chi2(ds['poses'].tensor(), ds['points']))
    loss = t.optimize(steps=8, patience=4, decreasing=1e-3)
    assert loss < 1e-2 * l0


def test_ba_unconverged_cg_does_not_diverge():
    ds = jax_problem(24, 400, 4, 3, (0.2, 0.08), 0.3)
    t = BundleAdjustment(ds['poses'], ds['points'], ds['cam_idx'],
                         ds['pt_idx'], ds['pixels'], ds['cameras'],
                         fix_first_pose=True, schur='cg', cg_iter=2,
                         cg_tol=1e-12)
    assert not t._use_dense_schur
    l0 = float(t._chi2(ds['poses'].tensor(), ds['points']))
    loss = t.optimize(steps=6, patience=6, decreasing=-1.0)
    assert np.isfinite(loss) and loss < l0


def test_ba_dense_schur_gate(monkeypatch):
    ds = jax_problem(6, 40, 3, 0)
    args = (ds['poses'], ds['points'], ds['cam_idx'], ds['pt_idx'],
            ds['pixels'], ds['cameras'])
    assert BundleAdjustment(*args)._use_dense_schur
    monkeypatch.setattr(BundleAdjustment, 'DENSE_SCHUR_MAX_C', 2)
    assert not BundleAdjustment(*args)._use_dense_schur
    with pytest.raises(ValueError):
        BundleAdjustment(*args, schur='dense')


def test_ba_windowed_small_problem_disabled():
    ds = jax_problem(8, 100, 3, 0)
    t = BundleAdjustment(ds['poses'], ds['points'], ds['cam_idx'],
                         ds['pt_idx'], ds['pixels'], ds['cameras'])
    assert t._cam_win is None


def test_entry_points_follow_their_inputs():
    """BundleAdjustment and ba_optimizer live on their inputs' device;
    the problem factories default to the card."""
    ds = ba_instance('ba-anchored', device='cpu')
    t = ba_optimizer(ds, 'ba-anchored')
    assert t.device.type == 'cpu' and t.cam_idx.device.type == 'cpu'
    assert t.strategy.init(t.dtype, t.device)['damping'].device.type == 'cpu'
    assert isinstance(ppt.optim.BundleAdjustment, type)
    assert ba.HOST_READS >= 0
