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
and ``nnk_tolerance_failures`` (``nn1_tolerance_failures`` for k = 1) is the
rule that holds the nearest-neighbour kernels to their plain versions.
"""

import numpy as np
import torch

from ..lietensor.lietensor import LieTensor, liealgebra, liegroup

_LTYPES = {lt.name: lt for lt in liegroup + liealgebra}


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
                  kernel=None, autodiff=False, **_):
    """The port's SparseLM on a pose-graph dict ``ds`` (``synthetic_sphere``,
    ``pgo_loops_instance``) as ``bench.py`` builds its pose-graph
    workloads: :func:`pgo_factors`, TrustRegion(``radius``), node 0
    fixed, on the tensors' device.  Extra keys of a schedule dict are
    ignored."""
    from ..optim.sparse import SparseLM
    from ..optim.strategy import TrustRegion
    dev = ds['edges'].device
    factors = pgo_factors(ds, split_chains, kernel, autodiff)
    fixed = torch.zeros(ds['nodes'].shape[0], dtype=torch.bool, device=dev)
    fixed[0] = True
    return SparseLM({'poses': ds['nodes']}, factors,
                    strategy=TrustRegion(radius=radius),
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
        return X[:, 1] - X[:, 0] - consts

    def batched_jacobian(values, consts):
        return residual(values, consts), {'x': J}

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
        return values['poses'][:, 0].Act(values['landmarks'][:, 0]) - meas

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
