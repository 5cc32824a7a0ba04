r"""Test helpers: state carried over from the JAX package as numpy, and a
group-aware closeness assertion.

Counterpart of ``pypose_tpu/testing/comparison.py:9-30`` (``assert_close``).
``params_from_numpy`` and ``strategy_state_from_numpy`` let a test start
the port's ``SparseLM`` from exactly the state the JAX package holds:
the caller passes ``np.asarray(X.tensor())`` for each LieTensor, so both
packages begin from bit-identical values.  ``random_stencil_system``
makes the random SPD systems on which the CG kernels are held against
their plain versions, ``pgo_loops_instance`` builds the random-loop pose
graph of the einsum route (over SE3, SO3 or Sim3), ``pgo_group_instance``
an SE3 pose graph's counterpart over SO3, RxSO3 or Sim3, and
``ring3_problem`` a Euclidean graph of t = 3 (or another t),
``pgo_factors`` and ``pgo_optimizer`` the port's factors and optimizer on
such graphs (with a robust kernel, or residual-only: ``residual_only``),
``two_phase`` sphere2500's two-phase schedule, ``reproj_pgo_instance`` and
``reproj_pgo_optimizer`` the reprojection pose graph of
``examples/reproj_pgo.py``, ``autograd_inputs`` the inputs at which the
autograd Functions are held on the card,
``instance_checksum`` identifies a generated pose-graph instance against
a recorded anchor (``bal_checksum`` a bundle-adjustment one),
``ba_instance`` and ``ba_optimizer`` build the bundle-adjustment cells,
``nnk_tolerance_failures`` (``nn1_tolerance_failures`` for k = 1) is the
rule that holds the nearest-neighbour kernels to their plain versions,
``module_state_from_numpy`` carries a JAX module's state (parameters and
LieTensor buffers) into a port module, and ``imu_instance`` and
``batch_lm_instance`` (with ``PoseInvB``) build the IMU and batch-lm
cells, ``epnp_instance`` (with ``pose_errors``), ``pendulum`` with
``filter_instance`` (``pf_draws`` a PF rollout's draws), and ``cartpole``
with ``cartpole_problem`` the EPnP, filter and MPC cells.
``cap_threads`` shares the CPUs among pytest-xdist's workers.
"""

import os

import numpy as np
import torch

from ..lietensor.lietensor import LieTensor, liealgebra, liegroup
from ..lietensor.utils import identity_se3
from ..nn import Module, Parameter

_LTYPES = {lt.name: lt for lt in liegroup + liealgebra}


def cap_threads():
    """Give torch's CPU kernels this process's share of the CPUs: the CPU
    count over the pytest-xdist workers (``PYTEST_XDIST_WORKER_COUNT``;
    one process when unset).  Each worker otherwise starts one intra-op
    thread a CPU, and six workers on eight CPUs oversubscribe them.  The
    port's test files call it when they are imported."""
    workers = int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // max(workers, 1)))


def params_from_numpy(params, ltypes, device=None, dtype=None):
    """Build SparseLM params from numpy arrays.

    Args:
        params: dict ``name -> np.ndarray [N, D]``.
        ltypes: dict ``name -> 'SO3' | 'so3' | 'SE3' | 'se3' | 'RxSO3' |
            'rxso3' | 'Sim3' | 'sim3'``; names not listed stay plain
            tensors.
        device, dtype: of the returned tensors (dtype defaults to the
            array's).
    """
    out = {}
    for name, a in params.items():
        t = torch.tensor(np.asarray(a), device=device, dtype=dtype)
        out[name] = LieTensor(t, ltype=_LTYPES[ltypes[name]]) \
            if name in ltypes else t
    return out


def strategy_state_from_numpy(state, device=None, dtype=None):
    """A strategy state (dict of scalars, e.g. TrustRegion's ``damping``
    and ``down``) as 0-d tensors."""
    return {k: torch.tensor(np.asarray(v), device=device, dtype=dtype)
            for k, v in state.items()}


def _numpy(x):
    x = x.tensor() if isinstance(x, LieTensor) else x
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_close(actual, expected, rtol=None, atol=None, **kwargs):
    """Assert closeness; for group LieTensors compares ``(a^-1 b).Log()``
    to 0, so that q and -q count as the same rotation."""
    if isinstance(actual, LieTensor) and isinstance(expected, LieTensor) \
            and not actual.ltype.on_manifold:
        error = _numpy((actual.Inv() @ expected).Log())
        np.testing.assert_allclose(error, np.zeros(error.shape),
                                   rtol=0 if rtol is None else rtol,
                                   atol=1e-5 if atol is None else atol)
        return
    a, b = _numpy(actual), _numpy(expected)
    if rtol is None:
        rtol = 1.3e-6 if a.dtype == np.float32 else 1e-7
    if atol is None:
        atol = 1e-5 if a.dtype == np.float32 else 1e-7
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, **kwargs)


def random_stencil_system(N, loop_offset, n_loops, fixed, generator,
                          device=None, t=6):
    """Folded lane-major operands of a random SPD stencil system: an
    odometry chain plus ``n_loops`` loop edges on one circular offset,
    random ``t`` x ``t`` Jacobian blocks (residual dimension t, as a pose
    graph over a group of tangent dimension t has), LM damping 0.1, node 0
    fixed if
    ``fixed`` (the generator of tests/ops/test_pallas_cg.py:make_system).
    Drawn from ``generator`` on ``device``; the shapes the kernels are
    held at are sphere2500's (2500, 157, 2000, True) and the 100k-pose
    graph's (100_000, 993, 80_000, True), whose offsets are (1, 993).
    Returns (offsets, (b_T, A_T, Minv_T, C_T))."""
    from ..ops.smallinv import blockinv
    from ..ops.spmv import StencilSpMV
    from ..ops.stencil_cg import fold_operands
    ar = torch.arange(N, device=device)
    li = torch.randint(0, N, (n_loops,), generator=generator, device=device)
    edges = torch.cat([torch.stack([ar[:-1], ar[1:]], 1),
                       torch.stack([li, (li + loop_offset) % N], 1)])
    J = torch.randn((edges.shape[0], t, 2, t), generator=generator,
                    device=device)
    sp = StencilSpMV(edges, N, t, device=device)
    D = torch.zeros((N, t, t), device=device)
    for a in range(2):
        D.index_add_(0, edges[:, a],
                     torch.einsum('edt,edu->etu', J[:, :, a], J[:, :, a]))
    dcorr = 0.1 * torch.diagonal(D, dim1=-2, dim2=-1).clamp(1e-6, 1e32)
    b = torch.randn((N, t), generator=generator, device=device)
    mask = torch.zeros(N, dtype=torch.bool, device=device)
    mask[0] = fixed
    offsets = tuple(sp.offsets)
    return offsets, fold_operands(b, D, dcorr,
                                  blockinv(D + torch.diag_embed(dcorr)),
                                  sp.precompute(J, J), offsets, mask)


# truth and noise sigmas of pgo_loops_instance: bench.py:bench_pgo_groups'
# for SO3 and Sim3, and its topology over SE3
_LOOPS_SIGMAS = {'SE3': (1.0, 0.1), 'SO3': (1.0, 0.1),
                 'Sim3': ((0.3, 0.2, 0.1), (0.1, 0.05, 0.05))}


def pgo_loops_instance(N=10_000, dtype=torch.float32, device='cuda',
                       group='SE3'):
    """The random-loop pose graph of ``bench.py:bench_pgo_groups``: the
    ring i -> i+1, the edge N-1 -> 0 and N // 10 random loops from
    ``np.random.default_rng(0)``, self-loops dropped.  ``group`` is 'SO3'
    (rotation averaging: truth ``randn_SO3(N)``, noise ``randn_SO3(N,
    sigma=0.1)``), 'Sim3' (truth ``randn_Sim3(N, sigma=(0.3, 0.2, 0.1))``,
    noise sigma (0.1, 0.05, 0.05)), as that benchmark draws them, or 'SE3'
    (truth sigma 1.0, noise 0.1: its topology over the group the other
    phases use).  Truth and noise come from ``torch.Generator`` seeds 0 and
    1, the initial poses are ``truth @ noise`` and the measurements exact,
    ``Z = truth_i^-1 truth_j``; all computed in float64 on the CPU, then
    rounded to ``dtype`` and moved to ``device`` (the card unless the
    caller asks for ``device='cpu'``), so the instance does not depend on
    the machine.  Returns dict(nodes=group[N], edges=int64[E, 2],
    poses=group[E], gt=group[N]).
    """
    ltype = _LTYPES[group]
    ii = np.arange(N - 1)
    loops = np.random.default_rng(0).integers(0, N, size=(N // 10, 2))
    loops = loops[loops[:, 0] != loops[:, 1]]
    edges = torch.as_tensor(np.concatenate(
        [np.stack([ii, ii + 1], 1), [[N - 1, 0]], loops]), dtype=torch.int64)
    work = torch.float64
    s_truth, s_noise = _LOOPS_SIGMAS[group]
    truth = ltype.randn(N, sigma=s_truth, dtype=work,
                        generator=torch.Generator().manual_seed(0))
    noise = ltype.randn(N, sigma=s_noise, dtype=work,
                        generator=torch.Generator().manual_seed(1))
    Z = truth[edges[:, 0]].Inv() @ truth[edges[:, 1]]
    return dict(nodes=(truth @ noise).to(device=device, dtype=dtype),
                edges=edges.to(device),
                poses=Z.to(device=device, dtype=dtype),
                gt=truth.to(device=device, dtype=dtype))


def pgo_group_instance(ds, group, generator=None):
    """The pose graph of an SE3 dataset dict ``ds`` (``load_g2o``,
    ``synthetic_sphere``) over another group, on ``ds``'s device and dtype:

    - ``'SO3'``: the poses' and measurements' rotations (rotation
      averaging), infos I_3;
    - ``'Sim3'``: poses and measurements lifted with scale 1, then each
      initial pose's scale multiplied by ``exp(0.05 N(0, 1))`` (a scale
      drift for the optimizer to remove), infos I_7;
    - ``'RxSO3'``: the rotations with the same scale draw, infos I_4;
    - ``'SE3'``: ``ds`` itself.

    The scale draw is made in float64 from ``generator`` (a CPU
    ``torch.Generator``, required for Sim3 and RxSO3) and then rounded and
    moved, so one seed gives one instance on every machine.  Returns
    dict(nodes, edges, poses, infos).
    """
    if group == 'SE3':
        return ds
    ltype = _LTYPES[group]
    X, Z = ds['nodes'].tensor(), ds['poses'].tensor()
    N, E = X.shape[0], Z.shape[0]
    if group == 'SO3':
        nodes, poses = X[:, 3:7], Z[:, 3:7]
    else:
        if not isinstance(generator, torch.Generator) \
                or generator.device.type != 'cpu':
            raise TypeError(f'pgo_group_instance({group!r}) needs a CPU '
                            'torch.Generator for its scale draw')
        s = torch.exp(0.05 * torch.randn((N, 1), generator=generator,
                                         dtype=torch.float64)).to(X)
        keep = slice(0, 7) if group == 'Sim3' else slice(3, 7)
        nodes = torch.cat([X[:, keep], s], dim=-1)
        poses = torch.cat([Z[:, keep], Z.new_ones((E, 1))], dim=-1)
    t = ltype.manifold[0]
    infos = torch.eye(t, dtype=X.dtype, device=X.device).expand(E, t, t)
    return dict(nodes=LieTensor(nodes, ltype=ltype), edges=ds['edges'],
                poses=LieTensor(poses, ltype=ltype), infos=infos)


def residual_only(factor):
    """``factor`` without its closed-form Jacobian: ``SparseLM`` takes the
    Jacobian of its residual by autodiff."""
    from ..optim.sparse import Factor
    return Factor(factor.residual, factor.indices, factor.consts,
                  factor.weight, kernel=factor.kernel)


def pgo_factors(ds, split_chains=True, kernel=None, autodiff=False):
    """The factors ``bench.py`` builds for a pose-graph dict ``ds``: one
    ``pgo_factor`` for each odometry run of ``split_chain_edges`` and one
    for the rest (or one for every edge, if not ``split_chains``), with
    the robust ``kernel`` if given, residual-only if ``autodiff``."""
    from ..optim.sparse import pgo_factor, split_chain_edges
    edges, poses = ds['edges'], ds['poses']
    dev = edges.device
    if split_chains:
        runs, rest = split_chain_edges(edges)
        rows = [torch.as_tensor(r, device=dev)
                for r in list(runs) + ([rest] if len(rest) else [])]
    else:
        rows = [slice(None)]
    factors = [pgo_factor(edges[r], poses[r], kernel=kernel) for r in rows]
    return [residual_only(f) for f in factors] if autodiff else factors


def pgo_optimizer(ds, radius, cg_iter, cg_tol, split_chains=True,
                  kernel=None, autodiff=False, strategy=None, **_):
    """The port's SparseLM on a pose-graph dict ``ds`` (``synthetic_sphere``,
    ``pgo_loops_instance``) as ``bench.py`` builds its pose-graph
    workloads: :func:`pgo_factors`, TrustRegion(``radius``) unless another
    ``strategy`` is given, node 0 fixed, on the tensors' device.  Extra
    keys of a schedule dict are ignored."""
    from ..optim.sparse import SparseLM
    from ..optim.strategy import TrustRegion
    dev = ds['edges'].device
    factors = pgo_factors(ds, split_chains, kernel, autodiff)
    fixed = torch.zeros(ds['nodes'].shape[0], dtype=torch.bool, device=dev)
    fixed[0] = True
    return SparseLM({'poses': ds['nodes']}, factors,
                    strategy=TrustRegion(radius=radius) if strategy is None
                    else strategy,
                    fixed={'poses': fixed}, cg_iter=cg_iter, cg_tol=cg_tol)


def two_phase(opt, opt2):
    """``bench.py:199-205``'s sphere2500 schedule: ``opt.optimize(steps=6,
    decreasing=1e-6, patience=2)``, then ``opt2`` (the same problem with a
    deeper CG) from where it stopped, ``optimize(steps=6, decreasing=1e-7,
    patience=2)``.  Returns (final chi2, the history of both phases)."""
    opt.optimize(steps=6, decreasing=1e-6, patience=2)
    opt2.params, opt2.strategy_state = opt.params, opt.strategy_state
    final = opt2.optimize(steps=6, decreasing=1e-7, patience=2)
    return final, list(opt.history) + list(opt2.history)


def ring3_problem(N=64, loop_offset=5, dtype=torch.float32, device='cuda',
                  t=3):
    """An arity-2 factor over a Euclidean [N, t] group (t = 3 unless asked
    otherwise) with a closed-form ``batched_jacobian``: points joined
    i -> i+1 and i -> i+loop_offset (mod N, one merged stencil of block
    size t), residual ``x_j - x_i - z_ij``
    with ``z`` the true differences plus 0.01-sigma noise, initial points
    0.5-sigma off the truth; drawn in float64 from ``torch.Generator``
    seed 0 on the CPU, then rounded to ``dtype`` and moved to ``device``.
    Returns (params {'x': [N, t]}, [factor], fixed {'x': node 0})."""
    from ..optim.sparse import Factor
    gen = torch.Generator().manual_seed(0)
    w = torch.float64
    i = torch.arange(N)
    edges = torch.cat([torch.stack([i, (i + 1) % N], 1),
                       torch.stack([i, (i + loop_offset) % N], 1)])
    truth = torch.randn((N, t), generator=gen, dtype=w)
    z = truth[edges[:, 1]] - truth[edges[:, 0]] \
        + 0.01 * torch.randn((edges.shape[0], t), generator=gen, dtype=w)
    x0 = truth + 0.5 * torch.randn((N, t), generator=gen, dtype=w)
    z, x0 = z.to(device=device, dtype=dtype), x0.to(device=device,
                                                    dtype=dtype)
    eye = torch.eye(t, dtype=dtype, device=device)
    J = torch.stack([-eye, eye], 1).expand(edges.shape[0], t, 2, t)

    def residual(values, consts):
        X = values['x']
        return X[1] - X[0] - consts

    def batched_jacobian(values, consts):
        X = values['x']
        return X[:, 1] - X[:, 0] - consts, {'x': J}

    fixed = torch.zeros(N, dtype=torch.bool, device=device)
    fixed[0] = True
    return ({'x': x0}, [Factor(residual, {'x': edges.to(device)}, z,
                               batched_jacobian=batched_jacobian)],
            {'x': fixed})


def reproj_pgo_instance(N=2500, L=7500, obs_per=6, seed=0,
                        dtype=torch.float32, device='cuda'):
    """The reprojection pose graph of ``examples/reproj_pgo.py`` at N poses
    and L landmarks: SE3 poses on a circle of radius 8 facing along it, R^3
    landmarks ``6 N(0, 1)``, odometry i -> i+1 (mod N) measured through
    ``Exp(0.01 N(0, 1))``, ``obs_per`` observations a pose of landmarks
    drawn uniformly, ``X.Act(lm)`` plus ``0.01 N(0, 1)``; initial poses
    ``Exp(0.2 N(0, 1)) @ truth`` (pose 0 exact), initial landmarks 0.5
    N(0, 1) off the truth.  Drawn from ``np.random.default_rng(seed)`` and
    computed in float64 on the CPU, then rounded to ``dtype`` and moved to
    ``device``, so both packages and every machine get the same arrays.
    Returns dict(poses, landmarks (initial values), gt_poses, gt_landmarks,
    edges [N, 2], odometry (SE3 [N]), obs_pose, obs_landmark [N obs_per],
    meas [N obs_per, 3])."""
    from ..lietensor.lietensor import SE3_type, se3_type
    rng = np.random.default_rng(seed)
    w = torch.float64
    t = np.linspace(0, 2 * np.pi, N, endpoint=False)
    half_yaw = (t + np.pi / 2) / 2
    z = np.zeros_like(t)
    gt = LieTensor(torch.tensor(np.stack(
        [8 * np.cos(t), 8 * np.sin(t), z, z, z, np.sin(half_yaw),
         np.cos(half_yaw)], -1)), ltype=SE3_type)
    gt_lm = torch.tensor(6.0 * rng.normal(size=(L, 3)))

    def exp(sigma, n):
        return LieTensor(torch.tensor(sigma * rng.normal(size=(n, 6))),
                         ltype=se3_type).Exp()
    ii = torch.arange(N)
    jj = (ii + 1) % N
    odo = (gt[ii].Inv() @ gt[jj]) @ exp(0.01, N)
    pi = torch.arange(N).repeat_interleave(obs_per)
    li = torch.as_tensor(rng.integers(0, L, size=N * obs_per))
    meas = gt[pi].Act(gt_lm[li]) \
        + 0.01 * torch.tensor(rng.normal(size=(N * obs_per, 3)))
    init = (exp(0.2, N) @ gt).tensor()
    init = torch.cat([gt.tensor()[:1], init[1:]])
    init_lm = gt_lm + 0.5 * torch.tensor(rng.normal(size=(L, 3)))

    def out(x):
        x = x.tensor() if isinstance(x, LieTensor) else x
        return x.to(device=device, dtype=dtype if x.dtype == w else x.dtype)
    return dict(poses=LieTensor(out(init), ltype=SE3_type),
                landmarks=out(init_lm),
                gt_poses=LieTensor(out(gt), ltype=SE3_type),
                gt_landmarks=out(gt_lm),
                edges=out(torch.stack([ii, jj], 1)),
                odometry=LieTensor(out(odo), ltype=SE3_type),
                obs_pose=out(pi), obs_landmark=out(li), meas=out(meas))


def reproj_pgo_optimizer(ds, cg_iter=150, cg_tol=1e-7, radius=1e6, **_):
    """The port's SparseLM on :func:`reproj_pgo_instance`'s dict, as
    ``examples/reproj_pgo.py`` builds it: a ``pgo_factor`` over the
    odometry and a residual-only factor ``X.Act(lm) - meas`` over (pose,
    landmark) pairs, pose 0 fixed, TrustRegion(``radius``, the example's
    default).  Extra keys of a schedule dict are ignored."""
    from ..optim.sparse import Factor, SparseLM, pgo_factor
    from ..optim.strategy import TrustRegion
    dev = ds['edges'].device

    def obs_residual(values, meas):
        return values['poses'][0].Act(values['landmarks'][0]) - meas

    obs = Factor(obs_residual, indices={'poses': ds['obs_pose'],
                                        'landmarks': ds['obs_landmark']},
                 consts=ds['meas'])
    N, L = ds['poses'].shape[0], ds['landmarks'].shape[0]
    fixed = {'poses': torch.zeros(N, dtype=torch.bool, device=dev),
             'landmarks': torch.zeros(L, dtype=torch.bool, device=dev)}
    fixed['poses'][0] = True
    return SparseLM({'poses': ds['poses'], 'landmarks': ds['landmarks']},
                    [pgo_factor(ds['edges'], ds['odometry']), obs],
                    strategy=TrustRegion(radius=radius), fixed=fixed,
                    cg_iter=cg_iter, cg_tol=cg_tol)


def instance_checksum(ds):
    """float64 sums of |nodes| and |poses| and the edge count of a pose
    graph dict (``synthetic_sphere``, ``load_g2o``): enough to tell one
    noise draw from another, on any device."""
    def abs_sum(X):
        return float(X.tensor().detach().double().abs().sum())
    return {'nodes_abs_sum': abs_sum(ds['nodes']),
            'poses_abs_sum': abs_sum(ds['poses']),
            'n_edges': int(ds['edges'].shape[0])}


# group -> (algebra, tangent dimension)
_AUTOGRAD_GROUPS = {'SO3': ('so3', 3), 'SE3': ('se3', 6),
                    'RxSO3': ('rxso3', 4), 'Sim3': ('sim3', 7)}


def autograd_inputs(name, n, rng):
    """float64 CPU inputs of the op ``name`` at batch n, drawn from the
    numpy generator ``rng`` (rotation angles up to 2.5, log-scales ~0.4),
    and which of them are group-valued."""
    prefix, kind = name.split('_', 1)
    group = {alg: g for g, (alg, _) in _AUTOGRAD_GROUPS.items()}.get(
        prefix, prefix)
    alg, tan = _AUTOGRAD_GROUPS[group]

    def algebra():
        x = rng.normal(size=(n, tan))
        if group in ('RxSO3', 'Sim3'):
            x[:, -1] *= 0.4
        rot = slice(0, 3) if group in ('SO3', 'RxSO3') else slice(3, 6)
        angle = np.linalg.norm(x[:, rot], axis=-1, keepdims=True)
        x[:, rot] *= np.minimum(1.0, 2.5 / angle)
        return torch.from_numpy(x)

    def grp():
        return LieTensor(algebra(), ltype=_LTYPES[alg]).Exp().tensor()
    if kind == 'Exp':
        return [algebra()], [False]
    if kind in ('Log', 'Inv'):
        return [grp()], [True]
    if kind in ('Act', 'Act4'):
        p = torch.from_numpy(2.0 * rng.normal(size=(n, 4 if kind == 'Act4'
                                                    else 3)))
        return [grp(), p], [True, False]
    if kind == 'Mul':
        return [grp(), grp()], [True, True]
    return [grp(), algebra()], [True, False]


def nnk_tolerance_failures(ref, nbr, d2, idx, idx_plain, rtol=1e-6,
                           atol=1e-6):
    """Where a k-nearest-neighbour result ``(d2 [R, k], idx [R, k])``
    breaks the rule that holds the ``nnk`` kernel to its plain version,
    whose indices are ``idx_plain [R, k]``.  In float64, with ``a`` a row
    of ``ref``, ``b`` the neighbour returned at a position and ``b'`` the
    plain version's at the same position, and
    ``tol = rtol (|a|^2 + |b|^2) + atol``:

    - the index: ``idx == idx_plain``, or a near-tie,
      ``| |a - b|^2 - |a - b'|^2 | <= tol``;
    - the row: its k indices are distinct;
    - the distance: ``|d2 - |a - b|^2| <= tol``.

    The kernel ranks by FMA-form float32 arithmetic and the plain version
    by separately rounded products, so the two may order or pick
    neighbours differently where the distances agree to within their
    rounding.  Returns counts of rows, as ints: ``differ`` (some index
    differs), ``index_failures``, ``repeat_failures``, ``d2_failures``,
    and ``max_d2_err`` (float)."""
    R = len(ref)
    idx, idx_plain, d2 = (a.reshape(R, -1) for a in (idx, idx_plain, d2))
    a = ref.double()[:, None, :]
    b = nbr.double()[idx]
    bp = nbr.double()[idx_plain]
    dist = ((a - b) ** 2).sum(-1)
    dist_p = ((a - bp) ** 2).sum(-1)
    tol = rtol * ((a * a).sum(-1) + (b * b).sum(-1)) + atol
    differ = idx != idx_plain
    err = (d2.double() - dist).abs()
    srt = idx.sort(-1).values
    repeats = (srt[:, 1:] == srt[:, :-1]).any(-1)
    return {'differ': int(differ.any(-1).sum()),
            'index_failures': int((differ & ((dist - dist_p).abs() > tol))
                                  .any(-1).sum()),
            'repeat_failures': int(repeats.sum()),
            'd2_failures': int((err > tol).any(-1).sum()),
            'max_d2_err': float(err.max()) if err.numel() else 0.0}


def nn1_tolerance_failures(ref, nbr, d2, idx, idx_plain, rtol=1e-6,
                           atol=1e-6):
    """:func:`nnk_tolerance_failures` for a nearest-neighbour result
    ``(d2 [R], idx [R])`` (k = 1), the rule that holds the ``nn1`` kernel
    to its plain version."""
    return nnk_tolerance_failures(ref, nbr, d2[:, None], idx[:, None],
                                  idx_plain[:, None], rtol, atol)


# the bundle-adjustment cells: the problem (synthetic_bal's arguments, or
# the vendored JAX instance) and the optimizer (bench.py:318-495)
BA_PROBLEMS = {
    'ba-anchored': 'jax_instance_bal_16_300.npz',
    'ba-trafalgar': dict(n_cams=257, n_points=65132,
                         obs_per_point=225911 / 65132, seed=0,
                         pose_noise=(0.3, 0.1), point_noise=0.5),
    'ba-large': dict(n_cams=2048, n_points=49152, obs_per_point=6, seed=0,
                     pose_noise=(0.2, 0.05), point_noise=0.3),
    'ba-autodiff-huber': dict(n_cams=64, n_points=8000, obs_per_point=6)}
BA_SCHEDULES = {
    'ba-anchored': dict(radius=1e4, fix_first_pose=False, steps=20,
                        patience=5, decreasing=1e-4),
    'ba-trafalgar': dict(fix_first_pose=True, cg_iter=40, cg_tol=1e-6,
                         steps=5, patience=3, decreasing=1e-3),
    'ba-large': dict(fix_first_pose=True, cg_iter=100, cg_tol=1e-6,
                     steps=10, patience=5, decreasing=1e-3),
    'ba-autodiff-huber': dict(fix_first_pose=True, cg_iter=40, cg_tol=1e-6,
                              steps=6, patience=6, decreasing=1e-3,
                              huber=5.0)}


# (first accepted step, final chi2) tolerances against the JAX anchors:
# tests/test_torch_ba_anchor.py says how they were measured
BA_HOLD = {'ba-trafalgar': (3e-4, 1e-3), 'ba-large': (1e-3, 1e-3)}


def ba_instance(name, device='cuda', dtype=torch.float32):
    """The problem of a bundle-adjustment cell (``BA_PROBLEMS``):
    ``synthetic_bal`` built by the port, or for 'ba-anchored' the JAX
    package's own instance (its pose noise is a ``jax.random`` draw)
    from ``data/``.  On the card unless the caller asks for the CPU."""
    from ..datasets import find_data, synthetic_bal
    from ..lietensor.utils import SE3
    spec = BA_PROBLEMS[name]
    if isinstance(spec, dict):
        return synthetic_bal(**spec, dtype=dtype, device=device)
    with np.load(find_data(spec)) as z:
        arrays = {k: torch.as_tensor(z[k], device=device) for k in z.files}
    for k in ('poses', 'gt_poses'):
        arrays[k] = SE3(arrays[k].to(dtype))
    for k in ('points', 'pixels', 'cameras', 'gt_points'):
        arrays[k] = arrays[k].to(dtype)
    return arrays


def ba_optimizer(ds, name, **overrides):
    """``BundleAdjustment`` of a bundle-adjustment cell on ``ds`` with the
    cell's arguments (``BA_SCHEDULES``; its optimize arguments are
    ignored), ``overrides`` taking their place.  'huber' is the delta of a
    Huber kernel."""
    from ..optim.ba import BundleAdjustment
    from ..optim.kernel import Huber
    from ..optim.strategy import TrustRegion
    kw = {k: v for k, v in BA_SCHEDULES[name].items()
          if k not in ('steps', 'patience', 'decreasing')}
    kw.update(overrides)
    if 'radius' in kw:
        kw['strategy'] = TrustRegion(radius=kw.pop('radius'))
    if 'huber' in kw:
        kw['kernel'] = Huber(delta=kw.pop('huber'))
    return BundleAdjustment(ds['poses'], ds['points'], ds['cam_idx'],
                            ds['pt_idx'], ds['pixels'], ds['cameras'], **kw)


def bal_checksum(ds):
    """float64 sums of |poses|, |points| and |pixels| and the observation
    count of a bundle-adjustment problem dict, on any device."""
    def abs_sum(X):
        X = X.tensor() if isinstance(X, LieTensor) else X
        return float(X.detach().double().abs().sum())
    return {'poses_abs_sum': abs_sum(ds['poses']),
            'points_abs_sum': abs_sum(ds['points']),
            'pixels_abs_sum': abs_sum(ds['pixels']),
            'n_obs': int(ds['pixels'].shape[0])}


def module_state_from_numpy(module, state, ltypes=None):
    """Set a module's parameters, buffers and plain attributes from numpy
    arrays (the JAX module's state), on the module's device: a name whose
    current value is a LieTensor, or that ``ltypes`` (``name -> 'SO3' |
    ...``) lists, becomes a LieTensor of that type (e.g.
    ``IMUPreintegrator``'s ``rot`` and ``Rij``, ``PoseInvB``'s ``pose``);
    parameters are copied in place.  Returns the module."""
    ltypes = ltypes or {}
    dev = next(iter(module.buffers()), next(iter(module.parameters()),
                                            torch.zeros(0))).device
    for name, arr in state.items():
        t = torch.tensor(np.asarray(arr), device=dev)
        cur = getattr(module, name, None)
        if name in ltypes:
            t = LieTensor(t, ltype=_LTYPES[ltypes[name]])
        elif isinstance(cur, LieTensor):
            t = LieTensor(t, ltype=cur.ltype)
        if name in module._parameters:
            with torch.no_grad():
                module._parameters[name].copy_(
                    t.tensor() if isinstance(t, LieTensor) else t)
        else:
            setattr(module, name, t)
    return module


def imu_instance(name, F, device='cuda', dtype=torch.float32):
    """IMU input ``(dt, gyro, acc)``, each [1, F, .], on ``device`` (the
    card unless the caller asks for ``device='cpu'``):

    - ``'bench'``: ``bench.py:bench_imu``'s constant input (dt 0.005,
      gyro (0, 0, 0.3), acc (0.2, 0, 9.81007));
    - ``'synth'``: ``examples/imu_integration.py:synthesize_imu`` (dt
      0.01, a constant yaw rate of 0.5 on a circle of radius 5, gravity,
      noise from ``np.random.default_rng(0)``: 1e-4 on gyro, 1e-3 on
      acc), drawn in float64 with numpy and rounded to ``dtype``, so the
      JAX package gets the same arrays.
    """
    kw = dict(dtype=dtype, device=device)
    if name == 'bench':
        return (torch.full((1, F, 1), 0.005, **kw),
                torch.tensor([0., 0., 0.3], **kw).expand(1, F, 3)
                .contiguous(),
                torch.tensor([0.2, 0., 9.81007], **kw).expand(1, F, 3)
                .contiguous())
    if name != 'synth':
        raise ValueError(f"imu_instance: name is 'bench' or 'synth', got "
                         f'{name!r}')
    w, R = 0.5, 5.0
    gyro = np.zeros((F, 3))
    gyro[:, 2] = w
    acc = np.zeros((F, 3))
    acc[:, 1] = R * w * w
    acc[:, 2] = 9.81007
    rng = np.random.default_rng(0)
    gyro += rng.normal(size=gyro.shape) * 1e-4
    acc += rng.normal(size=acc.shape) * 1e-3
    return (torch.full((1, F, 1), 0.01, **kw),
            torch.as_tensor(gyro[None], **kw),
            torch.as_tensor(acc[None], **kw))


class PoseInvB(Module):
    """``bench.py:bench_batch_lm``'s model: r = Log(Exp(pose) @ x), pose
    an se3 [1] starting at zero."""

    def __init__(self):
        super().__init__()
        self.pose = Parameter(identity_se3(1))

    def forward(self, input):
        return (self.pose.Exp() @ input).Log().tensor()


def batch_lm_instance(B, seed, device='cuda', sigma=0.5):
    """``bench.py:bench_batch_lm``'s problem: ``B`` SE3 targets [B, 1]
    (the Exp of se3 vectors with entries drawn from N(0, sigma^2) by
    ``np.random.default_rng(seed)``, computed in float64 on the CPU, then
    rounded to float32) and a :class:`PoseInvB` module, both on
    ``device`` (the card unless the caller asks for ``device='cpu'``).
    Returns (targets, module)."""
    from ..lietensor.utils import se3
    xi = sigma * np.random.default_rng(seed).normal(size=(B, 1, 6))
    targets = se3(torch.as_tensor(xi, dtype=torch.float64)).Exp()
    return (targets.to(device=device, dtype=torch.float32),
            PoseInvB().to(device))


# bench.py:bench_modules' EPnP intrinsics
EPNP_K = ((500., 0., 320.), (0., 500., 240.), (0., 0., 1.))


def epnp_instance(B, n=12, seed=0, device='cuda', dtype=torch.float32):
    """``bench.py:bench_modules``' EPnP problem at B problems of n points:
    camera-frame points uniform in [-2, 2] x [-2, 2] x [4, 12], the pose
    the Exp of an se3 vector drawn from N(0, 1) scaled by 0.5
    (translation) and 0.2 (rotation), world points ``pose.Inv().Act``,
    pixels through :data:`EPNP_K`; drawn by ``np.random.default_rng(seed)``
    and computed in float64 on the CPU, then rounded to ``dtype`` and
    moved to ``device`` (the card unless the caller asks for
    ``device='cpu'``).  Returns dict(points (world) [B, n, 3], pixels
    [B, n, 2], intrinsics [3, 3], pose (SE3 [B]))."""
    from ..function.geometry import point2pixel
    from ..lietensor.utils import se3
    rng = np.random.default_rng(seed)
    pts_cam = torch.as_tensor(rng.uniform([-2., -2., 4.], [2., 2., 12.],
                                          size=(B, n, 3)))
    xi = rng.normal(size=(B, 6)) * np.array([0.5] * 3 + [0.2] * 3)
    pose = se3(torch.as_tensor(xi)).Exp()
    K = torch.tensor(EPNP_K, dtype=torch.float64)
    world = pose.Inv().unsqueeze(-2).Act(pts_cam)
    pix = point2pixel(pts_cam, K)
    kw = dict(device=device, dtype=dtype)
    return dict(points=world.to(**kw), pixels=pix.to(**kw),
                intrinsics=K.to(**kw), pose=pose.to(**kw))


def pose_errors(est, truth):
    """Per problem, ``|Log(est^-1 truth)|_inf`` (bench.py's pose error)."""
    return (est.Inv() @ truth).Log().tensor().abs().amax(-1)


def pendulum():
    """``bench.py:bench_filters``' pendulum, an NLS: theta, omega with a
    0.05 s Euler step of ``-9.81 sin(theta) + u``, observed directly."""
    from ..module.dynamics import NLS

    class Pendulum(NLS):
        def state_transition(self, state, input, t=None):
            th, om = state[..., 0], state[..., 1]
            om = om + 0.05 * (-9.81 * torch.sin(th) + input[..., 0])
            return torch.stack([th + 0.05 * om, om], dim=-1)

        def observation(self, state, input, t=None):
            return state
    return Pendulum()


def filter_instance(T=1000, seed=0, device='cuda', dtype=torch.float32):
    """A T-step trajectory of :func:`pendulum`'s system for ``filter_rollout``:
    inputs u_t ~ N(0, 1), the true state from (0.3, 0) with process noise
    0.01 N(0, I) (Q = 1e-4 I), observations y_t = x_t + 0.1 N(0, I)
    (R = 1e-2 I) of the state before step t; drawn by
    ``np.random.default_rng(seed)`` and computed in float64 on the CPU,
    then rounded to ``dtype`` and moved to ``device`` (the card unless the
    caller asks for ``device='cpu'``).  Returns dict(us [T, 1], ys
    [T, 2], truth [T + 1, 2] (truth[t + 1] is what the estimate after
    step t estimates), x0 = 0, P0 = I, Q, R)."""
    rng = np.random.default_rng(seed)
    us = rng.normal(size=(T, 1))
    w = 0.01 * rng.normal(size=(T, 2))
    v = 0.1 * rng.normal(size=(T, 2))
    x = np.array([0.3, 0.0])
    truth, ys = [x], []
    for t in range(T):
        ys.append(x + v[t])
        om = x[1] + 0.05 * (-9.81 * np.sin(x[0]) + us[t, 0])
        x = np.array([x[0] + 0.05 * om, om]) + w[t]
        truth.append(x)
    kw = dict(device=device, dtype=dtype)
    return dict(us=torch.as_tensor(us, **kw),
                ys=torch.as_tensor(np.stack(ys), **kw),
                truth=torch.as_tensor(np.stack(truth), **kw),
                x0=torch.zeros(2, **kw), P0=torch.eye(2, **kw),
                Q=1e-4 * torch.eye(2, **kw), R=1e-2 * torch.eye(2, **kw))


def cartpole():
    """``bench.py:bench_modules``' cart-pole (the JAX package's MPC
    example plant): x, dx, theta, dtheta under force u, Euler step 0.05 s,
    g 9.81, cart 1.0, pole 0.1 at length 0.5, observed directly; an NLS."""
    from ..module.dynamics import NLS

    class CartPole(NLS):
        def state_transition(self, state, input, t=None):
            x, dx, th, dth = (state[..., 0], state[..., 1],
                              state[..., 2], state[..., 3])
            f = input[..., 0]
            dtt, g, mc, mp, l = 0.05, 9.81, 1.0, 0.1, 0.5
            tmp = (f + mp * l * dth ** 2 * torch.sin(th)) / (mc + mp)
            thacc = (g * torch.sin(th) - torch.cos(th) * tmp) / \
                (l * (4.0 / 3 - mp * torch.cos(th) ** 2 / (mc + mp)))
            xacc = tmp - mp * l * thacc * torch.cos(th) / (mc + mp)
            return torch.stack([x + dtt * dx, dx + dtt * xacc,
                                th + dtt * dth, dth + dtt * thacc], dim=-1)

        def observation(self, state, input, t=None):
            return state
    return CartPole()


def cartpole_problem(device='cuda', dtype=torch.float32):
    """``bench.py:bench_modules``' MPC cost and start: Q = diag(1, 0.1,
    10, 0.1, 0.01) [1, 5, 5], p = 0 [1, 5], x0 = (0, 0, 0.3, 0) [1, 4], on
    ``device`` (the card unless the caller asks for ``device='cpu'``).
    Returns (Q, p, x0)."""
    kw = dict(device=device, dtype=dtype)
    return (torch.diag(torch.tensor([1., 0.1, 10., 0.1, 0.01], **kw))[None],
            torch.zeros((1, 5), **kw),
            torch.tensor([[0.0, 0.0, 0.3, 0.0]], **kw))


# the anchored cells of the EPnP, filter and MPC slice: bench.py's sizes
EPNP_CELLS = {'epnp': (10_000, False), 'epnp-refine': (16, True)}
FILTER_CELLS = ('ekf', 'ukf', 'pf')
FILTER_T, FILTER_EVERY, PF_PARTICLES = 1000, 100, 1000
MPC_CELLS = {'mpc': (32, 5, False), 'mpc-ls': (128, 30, True)}


def _np64(x):
    x = x.tensor() if isinstance(x, LieTensor) else x
    return x.detach().cpu().double().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float64)


def epnp_solve(d, refine):
    """The port's EPnP on an :func:`epnp_instance` dict: float64 numpy
    (poses [B, 7], each problem's chosen candidate (int), its error
    against the true pose)."""
    from ..module import EPnP
    e = EPnP(intrinsics=d['intrinsics'], refine=refine)
    pose = e(d['points'], d['pixels'])
    c = e._candidates(d['points'], d['pixels'], d['intrinsics'])
    idx = e._best_index(c['errors'])
    return (_np64(pose), idx.cpu().numpy(),
            _np64(pose_errors(pose, d['pose'])))


def epnp_stats(errs):
    errs = np.asarray(errs)
    return {'median': float(np.median(errs)),
            'p99': float(np.percentile(errs, 99)), 'max': float(errs.max())}


def epnp_failures(name, want, poses, cands, errs):
    """An EPnP result held to a reference (``want``: 'stats' of its
    errors, 'candidates' (a digit string or a list), and the 'poses' and
    'errors' of its first problems): each compared pose within 2 (e +
    e_ref) + 1e-6 of the reference's; candidate flips at most 1% of the
    problems, or one; from 1,000 problems on, the median and 99th
    percentile of the errors at most 25% above the reference's and the
    largest at most twice it (below 1,000, and refined, they are float32
    noise; below the reference's is better, as on CUDA, whose null space
    comes from a float64 eigh).  Returns (failures, numbers)."""
    got = epnp_stats(errs)
    bad = []
    if len(errs) >= 1000:
        bad += [f'{name} {k}' for k in ('median', 'p99')
                if not got[k] <= 1.25 * want['stats'][k]]
        if not got['max'] <= 2 * want['stats']['max']:
            bad.append(f'{name} max')
    n = len(want['poses'])
    gap = np.abs(poses[:n] - np.asarray(want['poses'])).max(-1)
    far = int((gap > 2 * (errs[:n] + np.asarray(want['errors'])) + 1e-6)
              .sum())
    if far:
        bad.append(f'{name}: {far} of the first {n} poses')
    flips = int(sum(int(c) != int(w) for c, w in zip(cands,
                                                     want['candidates'])))
    if flips > max(1, 0.01 * len(cands)):
        bad.append(f'{name}: {flips} candidate flips')
    return bad, {'stats': got, 'flips': flips, 'pose_gap': float(gap.max())}


def pf_draws(T=FILTER_T, particles=PF_PARTICLES, n=2, dtype=torch.float64,
             seed=0):
    """A PF rollout's draws, made on the CPU by a ``torch.Generator``
    seeded ``seed``: (normals [T, particles, n], uniforms [T, particles]),
    which :func:`filter_rollouts` feeds through ``PF.draw`` so that two
    devices resample from the same numbers."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((T, particles, n), generator=gen, dtype=dtype),
            torch.rand((T, particles), generator=gen, dtype=dtype))


def _drawing(pf, z, r):
    """``pf`` with its ``draw`` reading step t's normals ``z[t]`` and
    uniforms ``r[t]`` in place of a generator."""
    steps, now = iter(zip(z, r)), {}

    def draw(kind, shape, like, generator):
        if kind == 'normal':
            now['normal'], now['uniform'] = next(steps)
        got = now[kind]
        assert tuple(got.shape) == tuple(shape)
        return got.to(like)
    pf.draw = draw
    return pf


def filter_rollouts(device='cuda', T=FILTER_T, seed=0, kinds=FILTER_CELLS,
                    d=None, draws=None):
    """The filter cells on ``d`` (by default ``filter_instance(T)``):
    ({kind: (xs, Ps)}, the instance); the PF of :data:`PF_PARTICLES`
    particles draws from a ``torch.Generator`` on ``device`` seeded
    ``seed``, or, given ``draws`` (:func:`pf_draws`' pair), from those."""
    from ..module import EKF, PF, UKF, filter_rollout
    d = filter_instance(T, device=device) if d is None else d

    def make_pf():
        pf = PF(pendulum(), d['Q'], d['R'], particles=PF_PARTICLES)
        return pf if draws is None else _drawing(pf, *draws)
    make = {'ekf': lambda: EKF(pendulum(), d['Q'], d['R']),
            'ukf': lambda: UKF(pendulum(), d['Q'], d['R']),
            'pf': make_pf}
    out = {}
    for kind in kinds:
        gen = torch.Generator(device=device).manual_seed(seed)
        out[kind] = filter_rollout(make[kind](), d['x0'], d['P0'], d['ys'],
                                   d['us'], generator=gen)
    return out, d


def filter_rmse(xs, truth):
    """RMSE of the estimates against the states they estimate."""
    return float(np.sqrt(((_np64(xs) - _np64(truth)[1:]) ** 2).mean()))


# The PF's RMSE against the true state over filter_instance(1000), held to
# a reference with other draws: over 10 generator seeds the port's CPU PF
# gave a standard deviation of 1.5e-3 of it and came at most 0.34% from
# the JAX anchor's; the UKF's is 7% from it.
PF_RMSE_RTOL = 0.01


def filter_failures(ref, truth, out, exact=('ekf', 'ukf'), tol=2e-5):
    """Filter results held to a reference (the JAX anchor, or another run
    as ``{kind: {'xs_every', 'P_final', 'rmse'}}``): the estimates at
    every 100th step and the final covariance of the kinds in ``exact``
    within ``tol`` (1 + magnitude); a PF not in ``exact`` (its draws
    differ from the reference's) by |its RMSE against the true state -
    the reference's|, within :data:`PF_RMSE_RTOL` of the reference's.
    Returns (failures, gaps)."""
    bad, gaps = [], {}
    for kind in [k for k in exact if k in out]:
        xs, Ps = _np64(out[kind][0]), _np64(out[kind][1])
        for name, got, want in (
                ('xs', xs[FILTER_EVERY - 1::FILTER_EVERY],
                 ref[kind]['xs_every']),
                ('P_final', Ps[-1], ref[kind]['P_final'])):
            want = np.asarray(want)
            gap = float(np.abs(got - want).max())
            gaps[f'{kind}_{name}'] = gap
            if not gap <= tol * (1 + np.abs(want).max()):
                bad.append(f'{kind} {name}')
    if 'pf' in out and 'pf' not in exact:
        gap = abs(filter_rmse(out['pf'][0], truth) - ref['pf']['rmse'])
        gaps['pf_rmse'] = gap
        if not gap <= PF_RMSE_RTOL * ref['pf']['rmse']:
            bad.append('pf rmse')
    return bad, gaps


def filter_summary(out, truth):
    """``out`` in the form :func:`filter_failures` takes as a reference."""
    res = {}
    for kind, (xs, Ps) in out.items():
        xs, Ps = _np64(xs), _np64(Ps)
        res[kind] = {'rmse': filter_rmse(xs, truth),
                     'xs_every': xs[FILTER_EVERY - 1::FILTER_EVERY].tolist(),
                     'P_final': Ps[-1].tolist()}
    return res


def mpc_cell(name, device='cuda'):
    """One MPC cell of :data:`MPC_CELLS` (``bench.py:bench_modules``' [mpc]
    and [mpc-ls]) on the port: (x, u, cost)."""
    from ..module import MPC
    from ..utils.stepper import ReduceToBason
    T, steps, ls = MPC_CELLS[name]
    Q, p, x0 = cartpole_problem(device=device)
    mpc = MPC(cartpole(), Q, p, T, stepper=ReduceToBason(steps=steps),
              line_search=ls)
    return mpc(0.05, x0)


def mpc_tail(x):
    """max |theta| over the back half of the horizon."""
    x = _np64(x)
    T = x.shape[1] - 1
    return float(np.abs(x[0, T // 2:, 2]).max())


def mpc_failures(name, want, x, cost, rtol=1e-4, tail_tol=1e-3,
                 against='the JAX anchor'):
    """The MPC cell ``name`` held to a reference (``want``: 'cost',
    'tail'): cost within ``rtol`` relative, the tail within ``tail_tol``
    (and below 0.1 with the line search, the JAX test's swing-up bound).
    Returns failures."""
    c, tl = float(_np64(cost).reshape(-1)[0]), mpc_tail(x)
    bad = []
    if not abs(c - want['cost']) <= rtol * abs(want['cost']):
        bad.append(f'{name} cost {c} against {against}\'s {want["cost"]}')
    if not abs(tl - want['tail']) <= tail_tol:
        bad.append(f'{name} tail {tl} against {against}\'s {want["tail"]}')
    if MPC_CELLS[name][2] and not tl < 0.1:
        bad.append(f'{name} tail {tl} not swung up')
    return bad
