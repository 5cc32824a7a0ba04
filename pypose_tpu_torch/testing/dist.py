r"""Runs of the sharded optimizers on several CPU ranks, for tests.

:func:`run_ranks` spawns ``world`` processes through
``torch.multiprocessing`` (start method ``spawn``), joins them in a gloo
process group on a ``FileStore`` in a given directory, runs a list of
tasks on every rank and returns each rank's results.  A task is
``(key, name, kwargs)``: ``TASKS[name](**kwargs)`` runs on every rank and
returns a dict of numpy arrays and floats.  Problems travel as numpy
arrays; the children import torch and this package only (each result
records whether ``jax`` was imported).
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist


def run_ranks(world, tasks, directory, threads=1):
    """Results of ``tasks`` on ``world`` gloo ranks: one dict a rank,
    ``{key: result}`` plus ``'jax_imported'``."""
    import torch.multiprocessing as mp
    directory = str(directory)
    mp.start_processes(_rank_main, args=(world, directory, tasks, threads),
                       nprocs=world, join=True, start_method='spawn')
    return [torch.load(os.path.join(directory, f'rank{r}.pt'),
                       weights_only=False) for r in range(world)]


def _rank_main(rank, world, directory, tasks, threads):
    torch.set_num_threads(threads)
    store = dist.FileStore(os.path.join(directory, 'store'), world)
    dist.init_process_group('gloo', store=store, rank=rank,
                            world_size=world)
    try:
        out = {key: TASKS[name](**kw) for key, name, kw in tasks}
        out['jax_imported'] = 'jax' in sys.modules
        torch.save(out, os.path.join(directory, f'rank{rank}.pt'))
    finally:
        dist.destroy_process_group()


def _mesh(shape=None, names=('dp',)):
    from torch.distributed.device_mesh import init_device_mesh
    shape = (dist.get_world_size(),) if shape is None else tuple(shape)
    return init_device_mesh('cpu', shape, mesh_dim_names=tuple(names))


def _kernel(kernel):
    from ..optim.kernel import Huber
    return None if kernel is None else Huber(delta=kernel)


def _np(x):
    x = x.tensor() if hasattr(x, 'ltype') else x
    return x.detach().cpu().numpy()


def pgo(nodes, edges, poses, infos=None, kernel=None, steps=4, shape=None,
        names=('dp',), node_axis=None, run=False, **kw):
    """ShardedPGO on float arrays (the dtype of ``nodes``): the chi2 of
    each ``step()`` (or of one ``run(steps)``) and the final nodes."""
    from ..lietensor.utils import SE3
    from ..parallel import ShardedPGO
    opt = ShardedPGO(SE3(torch.as_tensor(nodes)), torch.as_tensor(edges),
                     SE3(torch.as_tensor(poses)),
                     None if infos is None else torch.as_tensor(infos),
                     kernel=_kernel(kernel), mesh=_mesh(shape, names),
                     node_axis=node_axis, **kw)
    hist = [opt.run(steps)] if run else [opt.step() for _ in range(steps)]
    return dict(hist=np.asarray(hist), history=np.asarray(opt.history),
                nodes=_np(opt.nodes), scatter=opt.lm._force_scatter,
                local_rows={n: list(r) for n, r in opt.lm._rows.items()},
                local_edges=opt.lm.factors[0].num_edges)


def lm(nodes, edges, poses, infos, kernel, scatter, steps=4, **kw):
    """ShardedLM on one pgo_factor with the accumulation forced
    (``scatter``): chi2 per step and the final nodes."""
    from ..lietensor.utils import SE3
    from ..optim.sparse import pgo_factor
    from ..optim.strategy import TrustRegion
    from ..parallel import ShardedLM
    fixed = torch.zeros(nodes.shape[0], dtype=torch.bool)
    fixed[0] = True
    opt = ShardedLM({'poses': SE3(torch.as_tensor(nodes))},
                    [pgo_factor(torch.as_tensor(edges),
                                SE3(torch.as_tensor(poses)),
                                torch.as_tensor(infos), _kernel(kernel))],
                    mesh=_mesh(), strategy=TrustRegion(radius=1e4),
                    fixed={'poses': fixed}, scatter=scatter, **kw)
    hist = [opt.step() for _ in range(steps)]
    return dict(hist=np.asarray(hist), nodes=_np(opt.params['poses']),
                incidence=opt._inc[(0, 'poses')] is not None)


def pgo_step(nodes, edges, poses, n_steps=2, **kw):
    """make_pgo_step on this rank's slice of the edges, ``n_steps``
    times."""
    from ..parallel import make_pgo_step, shard_leading
    mesh = _mesh()
    step = make_pgo_step(nodes.shape[0], mesh=mesh, **kw)
    e = shard_leading(torch.as_tensor(edges), mesh).to_local()
    z = shard_leading(torch.as_tensor(poses), mesh).to_local()
    x, chi = torch.as_tensor(nodes), []
    for _ in range(n_steps):
        x, c = step(x, e, z)
        chi.append(float(c))
    return dict(chi2=np.asarray(chi), nodes=_np(x))


def lie_ops(X, p):
    """(X X^-1 X).Act(p) and X.Log() on this rank's rows of X and p."""
    from ..lietensor.utils import SE3
    from ..parallel import shard_leading
    mesh = _mesh()
    Xs = SE3(shard_leading(torch.as_tensor(X), mesh).to_local())
    ps = shard_leading(torch.as_tensor(p), mesh).to_local()
    return dict(act=_np((Xs @ Xs.Inv() @ Xs).Act(ps)),
                log=_np(Xs.Log().tensor()))


def placement(x):
    """The DTensors of shard_leading and replicate on this rank."""
    from ..parallel import make_mesh, replicate, shard_leading
    mesh = make_mesh(device_type='cpu')
    s, r = shard_leading(torch.as_tensor(x), mesh), \
        replicate(torch.as_tensor(x), mesh)
    try:
        make_mesh(dist.get_world_size() + 1, device_type='cpu')
        raised = False
    except ValueError:
        raised = True
    return dict(local=s.to_local().numpy(), full=s.full_tensor().numpy(),
                shard=str(s.placements), rep=str(r.placements),
                rep_local=r.to_local().numpy(), size=mesh.size(),
                wrong_size_raises=raised)


def ba(poses, points, cam_idx, pt_idx, pixels, cameras, kernel=None,
       steps=3, run=False, **kw):
    """ShardedBA: the chi2 of each step (or of one run) and the final
    state."""
    from ..lietensor.utils import SE3
    from ..parallel import ShardedBA
    opt = ShardedBA(SE3(torch.as_tensor(poses)), torch.as_tensor(points),
                    torch.as_tensor(cam_idx), torch.as_tensor(pt_idx),
                    torch.as_tensor(pixels), torch.as_tensor(cameras),
                    mesh=_mesh(), kernel=_kernel(kernel), **kw)
    hist = [opt.run(steps)] if run else [opt.step() for _ in range(steps)]
    return dict(hist=np.asarray(hist), poses=_np(opt.poses),
                points=_np(opt.points), local_obs=int(opt.pixels.shape[0]),
                masked=0 if opt.obs_valid is None
                else int((~opt.obs_valid).sum()))


def ba_step(poses, points, cam_idx, pt_idx, pixels, cameras, n_steps=2,
            **kw):
    """make_ba_step on this rank's slice of the observations (cameras
    [C, 3] taken per observation)."""
    from ..parallel import make_ba_step, shard_leading
    mesh = _mesh()
    step = make_ba_step(poses.shape[0], points.shape[0], mesh=mesh, **kw)
    cams = torch.as_tensor(cameras)[torch.as_tensor(cam_idx)]
    obs = [shard_leading(torch.as_tensor(a), mesh).to_local()
           for a in (cam_idx, pt_idx, pixels, cams)]
    T, X, chi = torch.as_tensor(poses), torch.as_tensor(points), []
    for _ in range(n_steps):
        T, X, c = step(T, X, *obs)
        chi.append(float(c))
    return dict(chi2=np.asarray(chi), poses=_np(T), points=_np(X))


def stencil(edges, N, tan, C, D, x):
    """sharded_stencil_matvec on this rank's block of nodes: y, and the
    messages and collectives of one matvec."""
    from ..ops.spmv import StencilSpMV
    from ..parallel import sharded_stencil_matvec, stencil as st_mod
    mesh = _mesh(names=('mp',))
    st = StencilSpMV(torch.as_tensor(edges), N, tan)
    mv = sharded_stencil_matvec(st, mesh, axis='mp')
    m, r = dist.get_world_size(), dist.get_rank()
    S = N // m
    rows = slice(r * S, (r + 1) * S)
    calls = {}
    saved = {}
    for name in ('all_reduce', 'all_gather', 'all_gather_into_tensor',
                 'broadcast', 'reduce_scatter', 'reduce_scatter_tensor'):
        saved[name] = getattr(dist, name)

        def count(*a, _n=name, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return saved[_n](*a, **k)
        setattr(dist, name, count)
    try:
        before = st_mod.MESSAGES
        y = mv(torch.as_tensor(C)[:, rows], torch.as_tensor(D)[rows],
               torch.as_tensor(x)[rows])
        messages = st_mod.MESSAGES - before
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
    return dict(y=_np(y), messages=messages, collectives=calls,
                offsets=list(st.offsets))


TASKS = dict(pgo=pgo, lm=lm, pgo_step=pgo_step, lie_ops=lie_ops,
             placement=placement, ba=ba, ba_step=ba_step, stencil=stencil)
