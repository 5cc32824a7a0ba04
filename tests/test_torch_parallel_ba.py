"""The port's ShardedBA and make_ba_step on CPU ranks, and
BundleAdjustment's ``obs_valid`` mask, against the JAX package on
identical numpy inputs (tests/conftest.py's 8-device virtual mesh).

The ranks (2 and 4, gloo) are spawned once a world size for the module
(``testing.dist.run_ranks``); the children never import JAX.

Tolerances.  ShardedBA on ``synthetic_bal(6, 60, 3, seed=9)`` with
Huber(10), camera 0 fixed, three steps, float32: the final chi2 within
the JAX package's own hold of ShardedBA to BundleAdjustment, rtol 5e-3
(Schur-CG) and 2e-2 (dense Schur), tests/parallel/test_sharding.py:
143-178; and against the port's BundleAdjustment alike.  make_ba_step,
float64, two steps: chi2 within 1e-9 relative, the state within 1e-8.
``obs_valid`` alone, float64, three steps: chi2 within 1e-9 relative
(Schur-CG) or 1e-6 (dense: its Gram runs on bf16-rounded operands in
another summation order, as tests/test_torch_ba.py holds it).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu.parallel as jpar
from pypose_tpu.datasets import synthetic_bal as jbal
from pypose_tpu.lietensor.utils import SE3 as JSE3
from pypose_tpu.optim.ba import BundleAdjustment as JBA
from pypose_tpu.optim.kernel import Huber as JHuber
from pypose_tpu_torch.lietensor.utils import SE3
from pypose_tpu_torch.optim.ba import BundleAdjustment
from pypose_tpu_torch.optim.kernel import Huber
from pypose_tpu_torch.testing import cap_threads
from pypose_tpu_torch.testing.dist import run_ranks

cap_threads()

requires_8 = pytest.mark.skipif(jax.device_count() < 8,
                                reason='needs 8 virtual devices')

KEYS = ('poses', 'points', 'cam_idx', 'pt_idx', 'pixels', 'cameras')


def problem(dtype=np.float32):
    ds = jbal(n_cams=6, n_points=60, obs_per_point=3, seed=9)
    out = {k: np.asarray(ds[k].tensor() if k == 'poses' else ds[k])
           for k in KEYS}
    return {k: v.astype(dtype) if v.dtype.kind == 'f' else
            v.astype(np.int64) for k, v in out.items()}


PROB = problem()
PROB64 = problem(np.float64)
BA_KW = dict(cg_iter=20, cg_tol=1e-6, fix_first_pose=True)
SCHUR_RTOL = {'cg': 5e-3, 'dense': 2e-2}


def jax_args(p, jdt=jnp.float32):
    return (JSE3(jnp.asarray(p['poses'], jdt)), jnp.asarray(p['points'], jdt),
            jnp.asarray(p['cam_idx']), jnp.asarray(p['pt_idx']),
            jnp.asarray(p['pixels'], jdt), jnp.asarray(p['cameras'], jdt))


def torch_args(p):
    return (SE3(torch.as_tensor(p['poses'])), torch.as_tensor(p['points']),
            torch.as_tensor(p['cam_idx']), torch.as_tensor(p['pt_idx']),
            torch.as_tensor(p['pixels']), torch.as_tensor(p['cameras']))


@functools.cache
def jax_sharded(schur):
    opt = jpar.ShardedBA(*jax_args(PROB), mesh=jpar.make_mesh(8),
                         kernel=JHuber(delta=10.0), schur=schur, **BA_KW)
    return np.asarray([opt.step() for _ in range(3)])


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    tasks = [(f'ba_{schur}', 'ba', dict(PROB, kernel=10.0, schur=schur,
                                        **BA_KW))
             for schur in ('cg', 'dense')]
    tasks += [('run', 'ba', dict(PROB, kernel=10.0, schur='cg', run=True,
                                 **BA_KW)),
              ('step', 'ba_step', dict(PROB64, cg_iter=20))]
    return {w: run_ranks(w, tasks, tmp_path_factory.mktemp(f'ba{w}'))
            for w in (2, 4)}


def test_children_never_import_jax(ranks):
    assert not any(r['jax_imported'] for rs in ranks.values() for r in rs)


@requires_8
@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('schur', ['cg', 'dense'])
def test_sharded_ba_matches_jax(ranks, world, schur):
    res = ranks[world]
    got = res[0][f'ba_{schur}']
    O = len(PROB['pixels'])
    assert got['local_obs'] == -(-O // world)
    assert sum(r[f'ba_{schur}']['masked'] for r in res) == (-O) % world
    for other in res[1:]:       # every rank holds the same bits
        np.testing.assert_array_equal(other[f'ba_{schur}']['poses'],
                                      got['poses'])
        np.testing.assert_array_equal(other[f'ba_{schur}']['hist'],
                                      got['hist'])
    rtol = SCHUR_RTOL[schur]
    np.testing.assert_allclose(got['hist'][-1], jax_sharded(schur)[-1],
                               rtol=rtol)
    single = BundleAdjustment(*torch_args(PROB), kernel=Huber(10.0),
                              schur=schur, **BA_KW)
    hist = [single.step() for _ in range(3)]
    np.testing.assert_allclose(got['hist'][-1], hist[-1], rtol=rtol)
    assert got['hist'][-1] <= got['hist'][0] * (1 + 1e-6)


def test_sharded_ba_run(ranks):
    """run(3) stops early only on a rejected step without progress; its
    final chi2 is at most the first step's."""
    got = ranks[2][0]['run']
    first = ranks[2][0]['ba_cg']['hist'][0]
    assert got['hist'][0] <= first * 1.01


def test_make_ba_step_matches_jax(ranks):
    p = PROB64
    with jax.enable_x64(True):
        step = jax.jit(jpar.make_ba_step(6, 60, cg_iter=20))
        T, X = jnp.asarray(p['poses']), jnp.asarray(p['points'])
        cams = jnp.asarray(p['cameras'])[jnp.asarray(p['cam_idx'])]
        chi = []
        for _ in range(2):
            T, X, c = step(T, X, jnp.asarray(p['cam_idx']),
                           jnp.asarray(p['pt_idx']), jnp.asarray(p['pixels']),
                           cams)
            chi.append(float(c))
    for world in (2, 4):
        got = ranks[world][0]['step']
        np.testing.assert_allclose(got['chi2'], chi, rtol=1e-9)
        np.testing.assert_allclose(got['poses'], np.asarray(T), rtol=0,
                                   atol=1e-8)
        np.testing.assert_allclose(got['points'], np.asarray(X), rtol=0,
                                   atol=1e-8)
        assert got['chi2'][1] < got['chi2'][0]


@pytest.mark.parametrize('schur', ['cg', 'dense'])
def test_obs_valid_matches_jax(schur):
    """A mask over the observations (in the input order, permuted by the
    camera sort) against the JAX BundleAdjustment with the same mask,
    float64, Huber(10): the masked observations leave chi2, and nothing
    else changes."""
    p = PROB64
    mask = np.random.default_rng(1).uniform(size=len(p['pixels'])) > 0.2
    kw = dict(BA_KW, schur=schur)
    with jax.enable_x64(True):
        j = JBA(*jax_args(p, jnp.float64), kernel=JHuber(delta=10.0), **kw)
        j.obs_valid = jnp.asarray(mask[j._obs_perm])
        j.strategy_state = j.strategy.init(jnp.float64)
        jhist = [j.step() for _ in range(3)]
    t = BundleAdjustment(*torch_args(p), kernel=Huber(10.0), **kw)
    np.testing.assert_array_equal(t._obs_perm, j._obs_perm)
    full = float(t._chi2(t.poses.tensor(), t.points))
    t.obs_valid = torch.as_tensor(mask[t._obs_perm])
    assert float(t._chi2(t.poses.tensor(), t.points)) < full
    thist = [t.step() for _ in range(3)]
    np.testing.assert_allclose(thist, jhist,
                               rtol=1e-9 if schur == 'cg' else 1e-6)
