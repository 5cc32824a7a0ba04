"""The port's ``parallel`` package on CPU ranks against the JAX package's on
its 8-device virtual mesh (tests/conftest.py), on identical numpy inputs:
meshes and placements, ShardedPGO at 2 and 4 gloo ranks, scatter against
incidence, ``run`` against repeated ``step``, ``make_pgo_step``, Lie ops
on local shards and a 2 x 2 mesh with ``node_axis``; and SparseLM's
``matvec=`` / ``scatter=`` keywords against the JAX package.

The ranks are spawned once a world size for the whole module
(``testing.dist.run_ranks``: ``torch.multiprocessing``, a ``FileStore``
under a temporary directory); the children never import JAX.

Tolerances.  ShardedPGO on ``_weighted_problem(40)`` (information
matrices, Huber(1), 59 edges: padded at 2 and 4 ranks) for four steps:
float64 chi2 within 1e-9 relative and nodes within 1e-8; float32 the JAX
test's rtol 5e-3 on chi2 and atol 2e-2 on the nodes
(tests/parallel/test_sharding.py).  Scatter and incidence accumulations,
float64: 1e-9.  ``run(4)`` and four ``step()`` calls run the same eager
operations: equal.  ``make_pgo_step`` float64: chi2 1e-9 relative,
nodes 1e-8.  Lie ops: the port's sharded rows equal its unsharded ones
bit for bit, and the JAX package's within 1e-5.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pypose_tpu as jpp
import pypose_tpu.parallel as jpar
from pypose_tpu.datasets import synthetic_sphere as jsphere
from pypose_tpu.lietensor.utils import SE3 as JSE3
from pypose_tpu.optim import sparse as jsp
from pypose_tpu.optim.kernel import Huber as JHuber
from pypose_tpu.optim.strategy import TrustRegion as JTrustRegion
import pypose_tpu_torch as ppt
from pypose_tpu_torch.lietensor.utils import SE3
from pypose_tpu_torch.optim import sparse as tsp
from pypose_tpu_torch.optim.strategy import TrustRegion
from pypose_tpu_torch.testing import cap_threads
from pypose_tpu_torch.testing.dist import run_ranks

cap_threads()

requires_8 = pytest.mark.skipif(jax.device_count() < 8,
                                reason='needs 8 virtual devices')


def weighted_problem(n=40, seed=5):
    """tests/parallel/test_sharding.py:_weighted_problem, as numpy: a
    sphere graph with information matrices scaled by 1 + U(0, 1)."""
    ds = jsphere(n_poses=n, loops_per_pose=0.5, seed=seed)
    E = ds['edges'].shape[0]
    scale = 1.0 + np.random.default_rng(0).uniform(0, 1, (E, 1, 1))
    return dict(nodes=np.asarray(ds['nodes'].tensor(), np.float64),
                edges=np.asarray(ds['edges'], np.int64),
                poses=np.asarray(ds['poses'].tensor(), np.float64),
                infos=np.broadcast_to(np.eye(6), (E, 6, 6)) * scale)


def cast(prob, dtype):
    return {k: v.astype(dtype) if v.dtype == np.float64 else v
            for k, v in prob.items()}


@functools.cache
def jax_weighted(dtype):
    """The JAX ShardedPGO on PROB (Huber(1), cg_iter 50, cg_tol 1e-6),
    once a dtype."""
    return jax_sharded_pgo(cast(PROB, dtype), dtype,
                           kernel=JHuber(delta=1.0), cg_iter=50, cg_tol=1e-6)


def jax_sharded_pgo(prob, dtype, steps=4, mesh=None, **kw):
    """The JAX package's ShardedPGO on its 8-device mesh: (chi2 per step,
    final nodes)."""
    with jax.enable_x64(dtype == np.float64):
        jdt = jnp.float64 if dtype == np.float64 else jnp.float32
        opt = jpar.ShardedPGO(
            JSE3(jnp.asarray(prob['nodes'], jdt)), jnp.asarray(prob['edges']),
            JSE3(jnp.asarray(prob['poses'], jdt)),
            infos=None if 'infos' not in prob
            else jnp.asarray(prob['infos'], jdt),
            mesh=jpar.make_mesh(8) if mesh is None else mesh, **kw)
        opt.lm.strategy_state = opt.lm.strategy.init(jdt)
        hist = [opt.step() for _ in range(steps)]
        return np.asarray(hist), np.asarray(opt.nodes)


PROB = weighted_problem()
DRY = weighted_problem(32, seed=11)
DRY.pop('infos')
LIE_X = np.asarray(jpp.randn_SE3(64, key=jax.random.PRNGKey(0)).tensor())
LIE_P = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (64, 3)))
PGO_KW = dict(kernel=1.0, cg_iter=50, cg_tol=1e-6)


def pgo_tasks():
    tasks = []
    for name, dt in (('f32', np.float32), ('f64', np.float64)):
        p = cast(PROB, dt)
        tasks.append((f'pgo_{name}', 'pgo', dict(p, **PGO_KW)))
    return tasks


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """Every task of this module, once at 2 and once at 4 ranks."""
    p64 = cast(PROB, np.float64)
    two = pgo_tasks() + [
        ('scatter', 'lm', dict(p64, scatter=True, **PGO_KW)),
        ('incidence', 'lm', dict(p64, scatter=False, **PGO_KW)),
        ('run', 'pgo', dict(p64, run=True, **PGO_KW)),
        ('step', 'pgo_step', dict(nodes=p64['nodes'], edges=p64['edges'],
                                  poses=p64['poses'], damping=1e-4,
                                  cg_iter=30)),
        ('placement', 'placement', dict(x=np.arange(64.0).reshape(16, 4)))]
    four = pgo_tasks() + [
        ('lie', 'lie_ops', dict(X=LIE_X, p=LIE_P)),
        ('mesh2x2', 'pgo', dict(cast(DRY, np.float32), shape=(2, 2),
                                names=('dp', 'mp'), node_axis='mp',
                                cg_iter=10, steps=2)),
        ('placement', 'placement', dict(x=np.arange(64.0).reshape(16, 4)))]
    return {w: run_ranks(w, tasks, tmp_path_factory.mktemp(f'ranks{w}'))
            for w, tasks in ((2, two), (4, four))}


def test_children_never_import_jax(ranks):
    assert not any(r['jax_imported'] for rs in ranks.values() for r in rs)


def test_parallel_exports():
    assert sorted(ppt.parallel.__all__) == sorted(jpar.__all__)
    for name in jpar.__all__:
        assert callable(getattr(ppt.parallel, name))


@pytest.mark.parametrize('world', [2, 4])
def test_mesh_and_placement(ranks, world):
    x = np.arange(64.0).reshape(16, 4)
    rows = 16 // world
    for r, res in enumerate(ranks[world]):
        got = res['placement']
        np.testing.assert_array_equal(got['local'],
                                      x[r * rows:(r + 1) * rows])
        np.testing.assert_array_equal(got['full'], x)
        np.testing.assert_array_equal(got['rep_local'], x)
        assert got['shard'] == '(Shard(dim=0),)'
        assert got['rep'] == '(Replicate(),)'
        assert got['size'] == world and got['wrong_size_raises']


@pytest.fixture
def one_rank():
    """A test that makes a mesh with nothing set up, and leaves no
    process group behind."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_make_mesh_with_nothing_set_up(one_rank):
    """As the JAX package's make_mesh() works on one device with nothing
    set up: a one-rank group, and a one-rank ShardedPGO equals SparseLM
    with the same (generic) matvec in float64."""
    import torch.distributed as dist
    mesh = ppt.parallel.make_mesh(device_type='cpu')
    assert dist.get_world_size() == 1 and mesh.size() == 1
    with pytest.raises(ValueError):
        ppt.parallel.make_mesh(2, device_type='cpu')
    p = cast(PROB, np.float64)
    nodes, poses = SE3(torch.as_tensor(p['nodes'])), \
        SE3(torch.as_tensor(p['poses']))
    infos = torch.as_tensor(p['infos'])
    from pypose_tpu_torch.optim.kernel import Huber
    s = ppt.parallel.ShardedPGO(nodes, p['edges'], poses, infos=infos,
                                kernel=Huber(1.0), mesh=mesh, cg_iter=50,
                                cg_tol=1e-6)
    fixed = torch.zeros(40, dtype=torch.bool)
    fixed[0] = True
    single = tsp.SparseLM(
        {'poses': nodes}, [tsp.pgo_factor(torch.as_tensor(p['edges']),
                                          poses, infos, Huber(1.0))],
        strategy=TrustRegion(radius=1e4), fixed={'poses': fixed},
        cg_iter=50, cg_tol=1e-6, matvec='generic')
    assert s.lm.route == single.route == 'einsum'
    assert [s.step() for _ in range(3)] == [single.step() for _ in range(3)]
    assert torch.equal(s.nodes, single.params['poses'].tensor())
    # tensors on another device than the mesh's raise
    from types import SimpleNamespace
    with pytest.raises(ValueError, match='cuda'):
        ppt.parallel.ShardedPGO(nodes, p['edges'], poses,
                                mesh=SimpleNamespace(device_type='cuda'))


@requires_8
@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('dtype', ['f32', 'f64'])
def test_sharded_pgo_matches_jax(ranks, world, dtype):
    dt = np.float32 if dtype == 'f32' else np.float64
    want_hist, want_nodes = jax_weighted(dt)
    res = ranks[world]
    got = res[0][f'pgo_{dtype}']
    assert got['scatter'] and got['local_edges'] == -(-59 // world)
    for other in res[1:]:       # every rank holds the same bits
        np.testing.assert_array_equal(other[f'pgo_{dtype}']['nodes'],
                                      got['nodes'])
        np.testing.assert_array_equal(other[f'pgo_{dtype}']['hist'],
                                      got['hist'])
    if dt == np.float64:
        np.testing.assert_allclose(got['hist'], want_hist, rtol=1e-9)
        np.testing.assert_allclose(got['nodes'], want_nodes, rtol=0,
                                   atol=1e-8)
    else:
        np.testing.assert_allclose(got['hist'], want_hist, rtol=5e-3)
        np.testing.assert_allclose(got['nodes'], want_nodes, rtol=0,
                                   atol=2e-2)
    assert got['hist'][-1] < got['hist'][0]


def test_scatter_matches_incidence(ranks):
    """ShardedLM at 2 ranks summing by scatter-add and by the incidence
    gather, float64: two implementations of the same math."""
    a, b = ranks[2][0]['scatter'], ranks[2][0]['incidence']
    assert not a['incidence'] and b['incidence']
    np.testing.assert_allclose(a['hist'], b['hist'], rtol=1e-9)
    np.testing.assert_allclose(a['nodes'], b['nodes'], rtol=0, atol=1e-8)
    assert a['hist'][-1] < a['hist'][0]


def test_run_matches_steps(ranks):
    a, b = ranks[2][0]['pgo_f64'], ranks[2][0]['run']
    assert len(b['history']) == 4
    np.testing.assert_array_equal(b['history'], a['hist'])
    np.testing.assert_array_equal(b['nodes'], a['nodes'])


def test_make_pgo_step_matches_jax(ranks):
    p = cast(PROB, np.float64)
    with jax.enable_x64(True):
        step = jax.jit(jpar.make_pgo_step(40, damping=1e-4, cg_iter=30))
        x, chi = jnp.asarray(p['nodes']), []
        for _ in range(2):
            x, c = step(x, jnp.asarray(p['edges']), jnp.asarray(p['poses']))
            chi.append(float(c))
        x = np.asarray(x)
    got = ranks[2][0]['step']
    np.testing.assert_allclose(got['chi2'], chi, rtol=1e-9)
    np.testing.assert_allclose(got['nodes'], x, rtol=0, atol=1e-8)
    assert got['chi2'][1] < got['chi2'][0]


def test_lie_ops_on_local_shards(ranks):
    res = ranks[4]
    act = np.concatenate([r['lie']['act'] for r in res])
    log = np.concatenate([r['lie']['log'] for r in res])
    X, p = SE3(torch.as_tensor(LIE_X)), torch.as_tensor(LIE_P)
    np.testing.assert_array_equal(act, (X @ X.Inv() @ X).Act(p).numpy())
    np.testing.assert_array_equal(log, X.Log().tensor().numpy())
    jX = jpp.SE3(jnp.asarray(LIE_X))
    np.testing.assert_allclose(
        act, np.asarray((jX @ jX.Inv() @ jX).Act(jnp.asarray(LIE_P))),
        rtol=0, atol=1e-5)
    np.testing.assert_allclose(log, np.asarray(jX.Log().tensor()), rtol=0,
                               atol=1e-5)


@requires_8
def test_2x2_mesh_with_node_axis(ranks):
    """__graft_entry__.py:dryrun_multichip's 2-D run: edges over 'dp',
    nodes over 'mp', two steps, against the JAX package on its 2 x 2
    mesh."""
    from jax.sharding import Mesh
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ('dp', 'mp'))
    want_hist, want_nodes = jax_sharded_pgo(cast(DRY, np.float32),
                                            np.float32, steps=2, mesh=mesh,
                                            node_axis='mp', cg_iter=10)
    res = ranks[4]
    for r, out in enumerate(res):
        got = out['mesh2x2']
        mp = r % 2              # rank (dp, mp) = (r // 2, r % 2)
        assert got['local_rows'] == {'poses': [16 * mp, 16 * (mp + 1)]}
        np.testing.assert_array_equal(got['nodes'],
                                      res[0]['mesh2x2']['nodes'])
        np.testing.assert_allclose(got['hist'], want_hist, rtol=5e-3)
        np.testing.assert_allclose(got['nodes'], want_nodes, rtol=0,
                                   atol=2e-2)
    assert np.isfinite(res[0]['mesh2x2']['hist']).all()


def sphere_pair(n=60, seed=3):
    """A float64 sphere graph for both packages."""
    ds = jsphere(n_poses=n, loops_per_pose=0.5, seed=seed)
    nodes = np.asarray(ds['nodes'].tensor(), np.float64)
    edges = np.asarray(ds['edges'], np.int64)
    poses = np.asarray(ds['poses'].tensor(), np.float64)
    return nodes, edges, poses


def two_group_factor(lib):
    """A factor over two variable groups (not the PGO shape): one point
    per pose, residual p_j - p_i - 1."""
    def residual(values, consts):
        return values['a'][1] - values['b'][0] - 1.0
    idx = {'a': np.stack([np.arange(5), (np.arange(5) + 1) % 5], 1),
           'b': np.arange(5)[:, None]}
    return (jsp.Factor if lib == 'jax' else tsp.Factor)(
        residual, {k: (jnp.asarray(v) if lib == 'jax'
                       else torch.as_tensor(v)) for k, v in idx.items()})


@pytest.mark.parametrize('matvec,scatter', [('generic', False),
                                            ('generic', True),
                                            ('coupling', False)])
def test_sparse_lm_keywords_match_jax_f64(matvec, scatter):
    """SparseLM(matvec=, scatter=) against the JAX package's, float64,
    three steps: chi2 within 1e-9 relative, poses within 1e-8; 'generic'
    never takes the stencil route."""
    nodes, edges, poses = sphere_pair()
    N = nodes.shape[0]
    sched = dict(cg_iter=100, cg_tol=1e-10, matvec=matvec, scatter=scatter)
    with jax.enable_x64(True):
        jopt = jsp.SparseLM(
            {'poses': JSE3(jnp.asarray(nodes))},
            [jsp.pgo_factor(jnp.asarray(edges.astype(np.int32)),
                            JSE3(jnp.asarray(poses)))],
            strategy=JTrustRegion(radius=1e4),
            fixed={'poses': jnp.zeros(N, bool).at[0].set(True)}, **sched)
        jopt.strategy_state = jopt.strategy.init(jnp.float64)
        jhist = [jopt.step() for _ in range(3)]
        jnodes = np.asarray(jopt.params['poses'].tensor())
    fixed = torch.zeros(N, dtype=torch.bool)
    fixed[0] = True
    topt = tsp.SparseLM(
        {'poses': SE3(torch.as_tensor(nodes))},
        [tsp.pgo_factor(torch.as_tensor(edges),
                        SE3(torch.as_tensor(poses)))],
        strategy=TrustRegion(radius=1e4), fixed={'poses': fixed}, **sched)
    assert (topt._spmv is None) == (jopt._spmv is None) \
        == (matvec == 'generic')
    assert topt._stencil_all is None or matvec != 'generic'
    assert (topt._inc[(0, 'poses')] is None) == scatter
    assert all(v is None for v in topt._inc.values()) == \
        all(v is None for v in jopt._inc.values())
    thist = [topt.step() for _ in range(3)]
    np.testing.assert_allclose(thist, jhist, rtol=1e-9)
    np.testing.assert_allclose(topt.params['poses'].tensor().numpy(),
                               jnodes, rtol=0, atol=1e-8)


def test_sparse_lm_keyword_errors():
    """The JAX package's errors: an unknown matvec, and 'coupling' on a
    graph without the PGO shape; 'generic' takes it."""
    params = {'a': torch.zeros(5, 1, dtype=torch.float64),
              'b': torch.zeros(5, 1, dtype=torch.float64)}
    jparams = {k: jnp.zeros((5, 1)) for k in params}
    for bad in ('stencil', 'dense'):
        with pytest.raises(ValueError, match='matvec must be'):
            tsp.SparseLM(params, [two_group_factor('torch')], matvec=bad)
        with pytest.raises(ValueError, match='matvec must be'):
            jsp.SparseLM(jparams, [two_group_factor('jax')], matvec=bad)
    with pytest.raises(ValueError, match='PGO shape'):
        tsp.SparseLM(params, [two_group_factor('torch')], matvec='coupling')
    with pytest.raises(ValueError, match='PGO shape'):
        jsp.SparseLM(jparams, [two_group_factor('jax')], matvec='coupling')
    opt = tsp.SparseLM(params, [two_group_factor('torch')], matvec='generic',
                       scatter=True)
    assert opt.route == 'einsum' and opt._spmv is None
