"""``metric/ape_rpe.py`` of the port against the JAX package on the same
numpy inputs, in float32 and float64: every ``etype`` of ``ape`` under no
alignment, SE3 (``align``) and Sim3 (``scale``) Umeyama and ``origin``;
``rpe`` by frames and by distance, one chain or ``all`` pairs, on the
estimate's or the reference's poses (``rpair``); the timestamp
association (stamp subsets, offsets, ties, duplicate stamps) and its
``thresh`` warning; ``Median`` of an even count (the JAX rule, the mean
of the two middle values); and tests/metric/test_metric.py's seven tests.

Tolerances: every statistic within 1e-9 (1 + |value|) in float64; in
float32 within 2e-5 + 1e-5 |value| (the same formulas; the Umeyama 3x3
SVD comes from another LAPACK: measured up to 1.9e-6 on the EuRoC-like
instance of tests/test_torch_metric_anchor.py).  Association and pair
lists are compared exactly.
"""

import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu as jpp
from pypose_tpu.metric import ape as jape, rpe as jrpe
from pypose_tpu.metric.ape_rpe import (StampedSE3 as JStamped,
                                       matching_time_indices as jmatch,
                                       pair_id as jpair_id)
import pypose_tpu_torch as ppt
from pypose_tpu_torch.metric import StampedSE3, ape, rpe
from pypose_tpu_torch.metric.ape_rpe import matching_time_indices, pair_id
from pypose_tpu_torch.testing import cap_threads

cap_threads()

DTYPES = [np.float32, np.float64]
ETYPES = ['translation', 'rotation', 'pose', 'radian', 'degree']
STATS = ['Max', 'Min', 'Mean', 'Median', 'RMSE', 'SSE', 'STD']


def se3_np(rng, n, t_sigma=1.0, r_sigma=0.3):
    """n SE3 storages (float64 numpy): translations N(0, t_sigma), unit
    quaternions of rotation vectors N(0, r_sigma)."""
    v = rng.normal(size=(n, 3)) * r_sigma
    th = np.linalg.norm(v, axis=-1, keepdims=True)
    q = np.concatenate([np.sin(th / 2) * v / np.maximum(th, 1e-300),
                        np.cos(th / 2)], -1)
    return np.concatenate([rng.normal(size=(n, 3)) * t_sigma, q], -1)


def compose(a, b):
    """SE3 storages a @ b in float64 numpy (through the JAX package)."""
    with jax.enable_x64(True):
        return np.array((jpp.SE3(jnp.asarray(a))
                         @ jpp.SE3(jnp.asarray(b))).tensor())


def trajectories(n=24, seed=0):
    """A reference and an estimate 3 cm / 0.03 rad off it, with a
    similarity drift (float64 numpy), and frame stamps."""
    rng = np.random.default_rng(seed)
    ref = np.cumsum(se3_np(rng, n, 0.5, 0.0), 0)[:, :3]
    ref = np.concatenate([ref, se3_np(rng, n)[:, 3:]], -1)
    est = compose(se3_np(rng, n, 0.03, 0.03), ref)
    est[:, :3] = 1.2 * est[:, :3] + np.array([0.5, -0.2, 0.1])
    return np.arange(n, dtype=np.float64), ref, est


def both(arr, dtype):
    """The same numpy array as a port SE3 and a JAX SE3."""
    a = np.asarray(arr, dtype)
    with jax.enable_x64(dtype == np.float64):
        return ppt.SE3(torch.tensor(a)), jpp.SE3(jnp.asarray(a))


def tol(dtype):
    return (1e-9, 1e-9) if dtype == np.float64 else (2e-5, 1e-5)


def assert_stats(got, want, dtype):
    atol, rtol = tol(dtype)
    if not isinstance(want, dict):
        got, want = {'value': got}, {'value': want}
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = float(got[k]), float(want[k])
        assert abs(g - w) <= atol + rtol * abs(w), (k, g, w)


@pytest.mark.parametrize('mode', ['none', 'align', 'scale', 'origin'])
@pytest.mark.parametrize('etype', ETYPES)
@pytest.mark.parametrize('dtype', DTYPES)
def test_ape_matches_jax(dtype, etype, mode):
    stamps, ref, est = trajectories()
    (r, jr), (e, je) = both(ref, dtype), both(est, dtype)
    kw = dict(etype=etype, align=mode == 'align', scale=mode == 'scale',
              origin=mode == 'origin')
    with jax.enable_x64(dtype == np.float64):
        want = jape(stamps, jr, stamps, je, **kw)
    got = ape(stamps, r, stamps, e, **kw)
    assert_stats(got, want, dtype)
    for k in STATS:             # otype names one statistic
        assert float(ape(stamps, r, stamps, e, otype=k, **kw)) == \
            float(got[k])


@pytest.mark.parametrize('assoc,all_,rpair', [
    ('frame', False, False), ('frame', True, False), ('frame', True, True),
    ('distance', False, False), ('distance', True, False),
    ('distance', True, True)])
@pytest.mark.parametrize('etype', ETYPES)
@pytest.mark.parametrize('dtype', DTYPES)
def test_rpe_matches_jax(dtype, etype, assoc, all_, rpair):
    stamps, ref, est = trajectories(seed=1)
    (r, jr), (e, je) = both(ref, dtype), both(est, dtype)
    delta = 2 if assoc == 'frame' else 1.5
    kw = dict(etype=etype, associate=assoc, delta=delta, rtol=0.5,
              all=all_, rpair=rpair)
    with jax.enable_x64(dtype == np.float64):
        want = jrpe(stamps, jr, stamps, je, **kw)
    assert_stats(rpe(stamps, r, stamps, e, **kw), want, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
def test_rpe_with_alignment_and_one_statistic(dtype):
    stamps, ref, est = trajectories(seed=2)
    (r, jr), (e, je) = both(ref, dtype), both(est, dtype)
    for kw in (dict(scale=True, otype='RMSE'),
               dict(align=True, nposes=10, otype='Median'),
               dict(origin=True, etype='degree', otype='Max')):
        with jax.enable_x64(dtype == np.float64):
            want = jrpe(stamps, jr, stamps, je, **kw)
        assert_stats(rpe(stamps, r, stamps, e, **kw), want, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
def test_pair_lists_match_jax(dtype):
    _, ref, _ = trajectories(n=60, seed=3)
    r, jr = both(ref, dtype)
    t, jt = StampedSE3(None, r), JStamped(None, jr)
    with jax.enable_x64(dtype == np.float64):
        for assoc, delta, rtol_, all_ in [
                ('frame', 1, 0.1, False), ('frame', 3, 0.1, True),
                ('distance', 1.0, 0.1, False), ('distance', 2.0, 0.2, True),
                ('distance', 0.7, 0.05, True)]:
            assert pair_id(t, delta, assoc, rtol_, all_) == \
                jpair_id(jt, delta, assoc, rtol_, all_)
        np.testing.assert_allclose(t.accumulated_distances,
                                   jt.accumulated_distances,
                                   rtol=tol(dtype)[1])
    with pytest.raises(ValueError):
        pair_id(t, 1e6, 'distance')
    with pytest.raises(ValueError):
        pair_id(t, 1, 'meters')


def test_matching_time_indices_match_jax():
    """The binary search picks what the JAX package's dense argmin picks:
    random stamps, exact ties between two neighbours (to the lower index),
    duplicate stamps (to the first), unsorted second stamps, offsets and
    stamps outside the other's range."""
    rng = np.random.default_rng(4)
    cases = [(np.sort(rng.uniform(0, 10, 50)), np.sort(rng.uniform(0, 10, 70)),
              0.05, 0.0),
             (np.arange(10) + 0.5, np.arange(12, dtype=np.float64), 0.6, 0.0),
             (np.arange(10) + 0.25, np.repeat(np.arange(6.0), 3), 0.3, 0.0),
             (np.arange(8.0), rng.permutation(np.arange(12.0)), 0.5, 0.0),
             (np.arange(20) * 0.1, np.arange(30) * 0.1, 0.02, 0.03),
             (np.arange(5) - 3.0, np.arange(4) * 0.5, 0.4, -0.1)]
    for s1, s2, max_diff, off in cases:
        assert matching_time_indices(s1, s2, max_diff, off) == \
            jmatch(s1, s2, max_diff, off)


@pytest.mark.parametrize('dtype', DTYPES)
def test_association_subset_offset_and_warning(dtype):
    """An estimate at every third stamp, shifted by 0.5 s and offset back:
    both packages pair the same poses; below ``thresh`` both warn."""
    stamps, ref, est = trajectories(n=30, seed=5)
    (r, jr), (e, je) = both(ref, dtype), both(est[::3], dtype)
    estamp = stamps[::3] + 0.5
    kw = dict(diff=0.05, offset=-0.5, scale=True)
    with jax.enable_x64(dtype == np.float64):
        want = jape(stamps, jr, estamp, je, **kw)
    assert_stats(ape(stamps, r, estamp, e, **kw), want, dtype)
    # without the offset only stamps within 0.6 s match: too few
    kw = dict(diff=0.6, thresh=0.9, etype='radian')
    with pytest.warns(Warning, match='not enough timestamps'):
        with jax.enable_x64(dtype == np.float64):
            want = jape(stamps[:12], jr[:12], estamp, je, **kw)
    with pytest.warns(Warning, match='not enough timestamps'):
        got = ape(stamps[:12], r[:12], estamp, e, **kw)
    assert_stats(got, want, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
def test_median_of_an_even_count(dtype):
    """Four errors: the JAX package's median, (a + b) * 0.5 of the two
    middle ones, where torch.median would take the lower."""
    stamps, ref, est = trajectories(n=4, seed=6)
    (r, jr), (e, je) = both(ref, dtype), both(est, dtype)
    with jax.enable_x64(dtype == np.float64):
        want = jape(stamps, jr, stamps, je, otype='Median')
    got = ape(stamps, r, stamps, e, otype='Median')
    assert_stats(got, want, dtype)
    err = torch.linalg.norm(e.translation() - r.translation(), dim=-1)
    s = torch.sort(err).values
    assert float(got) == float((s[1] + s[2]) * 0.5)
    assert float(got) != float(torch.median(err))


@pytest.mark.parametrize('etype', ['radian', 'degree', 'rotation'])
@pytest.mark.parametrize('dtype', DTYPES)
def test_rotation_errors_near_pi(dtype, etype):
    """Estimates turned by pi - 1e-3 ... pi about random axes: mat2SO3
    (check=False) and Log near pi, as the JAX package takes them."""
    rng = np.random.default_rng(8)
    stamps, ref, _ = trajectories(n=12, seed=8)
    axis = rng.normal(size=(12, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    th = np.pi - np.linspace(0, 1e-3, 12)[:, None]
    turn = np.concatenate([np.zeros((12, 3)), np.sin(th / 2) * axis,
                           np.cos(th / 2)], -1)
    (r, jr), (e, je) = both(ref, dtype), both(compose(turn, ref), dtype)
    with jax.enable_x64(dtype == np.float64):
        want = jape(stamps, jr, stamps, je, etype=etype)
    got = ape(stamps, r, stamps, e, etype=etype)
    assert_stats(got, want, dtype)
    if etype == 'radian' and dtype == np.float64:
        assert abs(float(got['Max']) - np.pi) < 1e-6


def test_unknown_types_raise():
    stamps, ref, est = trajectories(n=6)
    (r, _), (e, _) = both(ref, np.float64), both(est, np.float64)
    with pytest.raises(ValueError):
        ape(stamps, r, stamps, e, etype='full')
    with pytest.raises(ValueError):
        ape(stamps, r, stamps, e, otype='Mode')
    with pytest.raises(AssertionError):
        StampedSE3(stamps[::-1].copy(), r)


# --- tests/metric/test_metric.py's seven tests, on numpy draws ------------

def _traj(n=10, seed=0):
    rng = np.random.default_rng(seed)
    return (np.arange(n, dtype=np.float64),
            ppt.SE3(torch.tensor(se3_np(rng, n, 1.0, 0.3),
                                 dtype=torch.float32)))


def test_ape_identical_trajectories():
    stamps, gt = _traj()
    out = ape(stamps, gt, stamps, gt, etype='translation', otype='All')
    assert float(out['RMSE']) < 1e-6
    assert float(out['Max']) < 1e-6


def test_ape_constant_offset():
    stamps, gt = _traj(seed=1)
    data = gt.tensor().clone()
    data[..., :3] += torch.tensor([1., 0., 0.])
    est = ppt.SE3(data)
    out = ape(stamps, gt, stamps, est, etype='translation', otype='RMSE')
    np.testing.assert_allclose(float(out), 1.0, rtol=1e-5)
    out_aligned = ape(stamps, gt, stamps, est, etype='translation',
                      align=True, otype='RMSE')
    assert float(out_aligned) < 2e-2


def test_ape_rotation_stats_vs_numpy():
    stamps, gt = _traj(seed=2)
    rng = np.random.default_rng(3)
    est = ppt.SE3(torch.tensor(se3_np(rng, 10, 0.5, 0.2),
                               dtype=torch.float32)) @ gt
    out = ape(stamps, gt, stamps, est, etype='radian', otype='All')
    R_est = est.rotation().matrix().numpy()
    R_gt = gt.rotation().matrix().numpy()
    errs = np.asarray([np.arccos(np.clip((np.trace(a.T @ b) - 1) / 2, -1, 1))
                       for a, b in zip(R_est, R_gt)])
    np.testing.assert_allclose(float(out['Mean']), errs.mean(), rtol=1e-3)
    np.testing.assert_allclose(float(out['RMSE']),
                               np.sqrt((errs ** 2).mean()), rtol=1e-3)


def test_rpe_frame_pairs():
    stamps, gt = _traj(n=12, seed=4)
    out = rpe(stamps, gt, stamps, gt, etype='translation', delta=1,
              otype='RMSE')
    assert float(out) < 1e-6


def test_rpe_scale_drift():
    stamps, gt = _traj(n=12, seed=5)
    data = gt.tensor().clone()
    data[..., :3] *= 1.5
    out = rpe(stamps, gt, stamps, ppt.SE3(data), etype='translation',
              delta=1, otype='Mean')
    assert float(out) > 0.05


def test_associate_subset():
    stamps, gt = _traj(n=10, seed=6)
    out = ape(stamps, gt, stamps[::2], gt[::2], etype='translation',
              otype='RMSE', thresh=0.1)
    assert float(out) < 1e-6


def test_stamped_se3_accumulated_distances():
    data = ppt.identity_SE3(4).tensor().clone()
    data[:, 0] = torch.tensor([0., 1., 2., 3.])
    traj = StampedSE3(None, ppt.SE3(data))
    np.testing.assert_allclose(traj.accumulated_distances, [0, 1, 2, 3],
                               atol=1e-6)


def test_no_warning_when_every_stamp_matches():
    stamps, gt = _traj(n=8, seed=7)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        ape(stamps, gt, stamps, gt)
