r"""g2o pose graphs and BAL bundle-adjustment problems: files and
synthetic generators.

Counterpart of ``pypose_tpu/datasets.py:20-263, 266-345``.  ``load_g2o``
and ``load_bal`` parse through the native tokenizer (``native/``, built
with g++ at first use; a failed build or parse raises).
``synthetic_sphere`` and ``synthetic_bal`` rebuild the JAX generators'
topology and ground truth exactly but draw their pose noise from a
``torch.Generator``, so their problems are not the JAX package's: the
sphere2500 headline reads the JAX instance from
``data/synthetic_sphere2500_seed42.g2o`` instead, and ba-anchored from
``data/jax_instance_bal_16_300.npz``.
"""

import os

import numpy as np
import torch

from . import native
from .lietensor.convert import euler2SO3, mat2SO3
from .lietensor.utils import SE3, SO3, randn_SE3, so3


def find_data(name):
    """Locate a data file: ``$PYPOSE_TPU_DATA/name``, then the repo-level
    ``data/name``.  Returns the path or None."""
    cands = []
    env = os.environ.get('PYPOSE_TPU_DATA')
    if env:
        cands.append(os.path.join(env, name))
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cands.append(os.path.join(here, 'data', name))
    for c in cands:
        if os.path.exists(c):
            return c
    return None


def _storage(x):
    x = x.tensor() if hasattr(x, 'tensor') else x
    x = x.detach().cpu().numpy() if torch.is_tensor(x) else x
    return np.asarray(x, np.float64)


def save_g2o(path, nodes, edges, poses, infos=None):
    """Write a pose graph in g2o VERTEX_SE3:QUAT / EDGE_SE3:QUAT format
    (row-major upper-triangular 6x6 information)."""
    nodes, poses = _storage(nodes), _storage(poses)
    edges = edges.cpu().numpy() if torch.is_tensor(edges) \
        else np.asarray(edges)
    iu = np.triu_indices(6)
    if infos is None:
        infos = np.broadcast_to(np.eye(6), (edges.shape[0], 6, 6))
    infos = _storage(infos)
    with open(path, 'w') as f:
        for i, v in enumerate(nodes):
            f.write('VERTEX_SE3:QUAT %d ' % i
                    + ' '.join('%.12g' % x for x in v) + '\n')
        for (i, j), z, w in zip(edges, poses, infos):
            f.write('EDGE_SE3:QUAT %d %d ' % (i, j)
                    + ' '.join('%.12g' % x for x in z) + ' '
                    + ' '.join('%.12g' % x for x in w[iu]) + '\n')


def load_g2o(path, dtype=torch.float32, device='cuda'):
    """Parse a g2o file with VERTEX_SE3:QUAT / EDGE_SE3:QUAT records
    through the native tokenizer (``native.parse_g2o``).

    Vertices are sorted by id and edges renumbered to rows.  Returns
    dict(nodes=SE3[N], edges=int64[E, 2], poses=SE3[E] relative
    measurements, infos=[E, 6, 6] information matrices), all on
    ``device``: the card unless the caller asks for ``device='cpu'``.
    Without a card the default raises, as torch does for a CUDA tensor.
    """
    vids, verts, edges, meas, infos_u = native.parse_g2o(path)
    order = np.argsort(vids)
    sorted_ids = vids[order]
    edges = np.searchsorted(sorted_ids, edges) if len(edges) else edges
    iu = np.triu_indices(6)
    infos = np.zeros((len(infos_u), 6, 6))
    infos[:, iu[0], iu[1]] = infos_u
    infos = infos + np.triu(infos, 1).transpose(0, 2, 1)
    return dict(
        nodes=SE3(torch.as_tensor(verts[order], dtype=dtype, device=device)),
        edges=torch.as_tensor(edges, dtype=torch.int64, device=device),
        poses=SE3(torch.as_tensor(meas, dtype=dtype, device=device)),
        infos=torch.as_tensor(infos, dtype=dtype, device=device),
    )


def load_bal(path, dtype=torch.float32, device='cuda'):
    """Parse a BAL (Bundle Adjustment in the Large) problem file through
    the native tokenizer (``native.parse_bal``).

    Format: header ``n_cams n_points n_obs``; per observation ``cam pt u
    v``; per camera 9 numbers (Rodrigues(3), t(3), f, k1, k2); per point
    3.  Returns dict(poses=SE3[C], points=[P, 3], cam_idx=int64[O],
    pt_idx=int64[O], pixels=[O, 2], cameras=[C, 3] (f, k1, k2)) on
    ``device`` (the card unless the caller asks for ``device='cpu'``).
    The quaternions are ``so3(rodrigues).Exp()`` in float64 on the CPU,
    then rounded to ``dtype``.
    """
    cam_idx, pt_idx, pixels, cams, points = native.parse_bal(path)
    q = so3(torch.as_tensor(cams[:, :3])).Exp().tensor()
    poses = torch.cat([torch.as_tensor(cams[:, 3:6]), q], dim=-1)
    return dict(poses=SE3(poses.to(device=device, dtype=dtype)),
                points=torch.as_tensor(points, dtype=dtype, device=device),
                cam_idx=torch.as_tensor(cam_idx, device=device),
                pt_idx=torch.as_tensor(pt_idx, device=device),
                pixels=torch.as_tensor(pixels, dtype=dtype, device=device),
                cameras=torch.as_tensor(cams[:, 6:9], dtype=dtype,
                                        device=device))


def save_bal(path, poses, points, cam_idx, pt_idx, pixels, cameras):
    """Write a problem in BAL text format (header ``C P O``; per
    observation ``cam pt u v``; per camera Rodrigues(3), t(3), f, k1, k2;
    per point 3), 12 significant digits.  Per-observation intrinsics
    ``[O, 3]`` are collapsed to their cameras'."""
    data = _storage(poses)
    rod = SO3(torch.as_tensor(data[:, 3:])).Log().tensor().numpy()
    cameras = _storage(cameras)
    C = data.shape[0]
    cam_idx = np.asarray(_index(cam_idx))
    if cameras.shape[0] != C:
        per_cam = np.zeros((C, 3))
        per_cam[cam_idx] = cameras
        cameras = per_cam
    points, pixels = _storage(points), _storage(pixels)
    pt_idx = np.asarray(_index(pt_idx))
    with open(path, 'w') as f:
        f.write(f'{C} {points.shape[0]} {pixels.shape[0]}\n')
        for c, p, (u, v) in zip(cam_idx, pt_idx, pixels):
            f.write(f'{c} {p} {u:.12g} {v:.12g}\n')
        for c in range(C):
            for x in (*rod[c], *data[c, :3], *cameras[c]):
                f.write('%.12g\n' % x)
        for p in points:
            for x in p:
                f.write('%.12g\n' % x)


def _index(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def synthetic_bal(n_cams=16, n_points=800, obs_per_point=4, f=500.0,
                  pose_noise=(0.05, 0.02), point_noise=0.05,
                  pixel_noise=0.5, seed=0, dtype=torch.float32,
                  device='cuda'):
    """Deterministic synthetic BAL-style bundle-adjustment problem.

    Cameras ring the origin at radius 10, height 2, looking at it; each
    point (``N(0, 2^2)`` per coordinate) is seen by ``obs_per_point``
    random cameras (a fractional value gives the first points one more,
    as real BAL files have, e.g. trafalgar's 225,911 / 65,132).  The
    topology, the ground truth, the pixel noise and the point noise come
    from ``np.random.default_rng(seed)`` in the JAX generator's draw
    order and are computed in ``dtype`` as there, so they equal the JAX
    package's arrays.  The pose noise (``pose_noise = (sigma_t,
    sigma_r)``, left-multiplied, camera 0 kept at its ground truth) comes
    from ``torch.Generator().manual_seed(seed)``, drawn and applied in
    float64 on the CPU and then rounded to ``dtype``, where the JAX
    generator draws ``jax.random``: same distribution, other numbers, the
    same on every machine.

    Returns dict(poses=SE3[C] noisy, points=[P, 3] noisy,
    cam_idx=int64[O], pt_idx=int64[O], pixels=[O, 2], cameras=[C, 3]
    (f, 0, 0), gt_poses=SE3[C], gt_points=[P, 3]) on ``device``: the
    card unless the caller asks for ``device='cpu'``.

    Example:
        >>> from pypose_tpu_torch.datasets import synthetic_bal
        >>> ds = synthetic_bal(4, 60, 3, device='cpu')
        >>> tuple(ds['poses'].lshape), tuple(ds['pixels'].shape)
        ((4,), (180, 2))
    """
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n_cams) / n_cams
    centers = np.stack([10 * np.cos(ang), 10 * np.sin(ang),
                        2 * np.ones(n_cams)], axis=-1)
    fwd = -centers / np.linalg.norm(centers, axis=-1, keepdims=True)
    up = np.broadcast_to(np.array([0., 0., 1.]), fwd.shape)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    down = np.cross(fwd, right)
    R_wc = np.stack([right, down, fwd], axis=-2)     # rows: camera axes
    t_wc = -np.einsum('cij,cj->ci', R_wc, centers)
    q = mat2SO3(torch.as_tensor(R_wc, dtype=dtype), check=False).tensor()
    gt_poses = SE3(torch.cat([torch.as_tensor(t_wc, dtype=dtype), q], -1))
    gt_points = torch.as_tensor(rng.normal(size=(n_points, 3)) * 2.0,
                                dtype=dtype)
    if float(obs_per_point) == int(obs_per_point):
        obs_per_point = int(obs_per_point)
        cam_idx = np.sort(rng.integers(0, n_cams,
                                       size=(n_points, obs_per_point)), 1)
        pt_idx = np.repeat(np.arange(n_points), obs_per_point)
        cam_idx = cam_idx.reshape(-1)
    else:
        base = int(np.floor(obs_per_point))
        extra = int(round((obs_per_point - base) * n_points))
        counts = np.full(n_points, base)
        counts[:extra] += 1
        pt_idx = np.repeat(np.arange(n_points), counts)
        cam_idx = rng.integers(0, n_cams, size=pt_idx.shape[0])
    cam_idx = torch.as_tensor(cam_idx, dtype=torch.int64)
    pt_idx = torch.as_tensor(pt_idx, dtype=torch.int64)
    cameras = torch.tensor([f, 0., 0.], dtype=dtype).expand(n_cams, 3)
    Xc = gt_poses[cam_idx].Act(gt_points[pt_idx])
    p = -Xc[:, :2] / Xc[:, 2:3]
    pixels = f * p + torch.as_tensor(
        rng.normal(size=(len(cam_idx), 2)) * pixel_noise, dtype=dtype)

    gen = torch.Generator().manual_seed(seed)
    noise = randn_SE3(n_cams, sigma=pose_noise, generator=gen,
                      dtype=torch.float64)
    poses0 = (noise @ gt_poses.to(dtype=torch.float64)).tensor().to(dtype)
    poses0[0] = gt_poses.tensor()[0]
    points0 = gt_points + torch.as_tensor(
        rng.normal(size=(n_points, 3)) * point_noise, dtype=dtype)
    return dict(poses=SE3(poses0.to(device)), points=points0.to(device),
                cam_idx=cam_idx.to(device), pt_idx=pt_idx.to(device),
                pixels=pixels.to(device), cameras=cameras.contiguous().to(
                    device),
                gt_poses=gt_poses.to(device=device),
                gt_points=gt_points.to(device))


def synthetic_sphere(n_poses=2500, radius=25.0, loops_per_pose=0.8,
                     meas_sigma=(0.05, 0.02), init_sigma=(1.0, 0.3),
                     seed=42, dtype=torch.float32, info='identity',
                     device='cuda'):
    """Deterministic sphere-world pose graph (sphere2500-like).

    Poses spiral over a sphere (golden angle); odometry edges chain
    consecutive poses and loop closures join pose ``i`` to ``i + stride``,
    ``stride = int(sqrt(n) * pi)``, one ring on.  The loop indices come
    from ``np.random.default_rng(seed)`` and the ground truth is closed
    form, both exactly as in the JAX generator.  The measurement noise
    (``meas_sigma``) and the initial-pose noise (``init_sigma``, both
    ``(sigma_t, sigma_r)`` se3 draws) come from
    ``torch.Generator().manual_seed(seed)`` on the CPU, where the JAX
    generator uses ``jax.random``: the distributions are the same, the
    numbers are not.  Pose 0 is pinned to the ground truth.  Everything is
    computed in float64 on the CPU, then rounded to ``dtype`` and moved to
    ``device``: torch's float32 sin/cos/exp kernels differ between CPU
    vector paths (up to 2e-4 in cos between its AVX2 and AVX512 kernels),
    the float64 ones round to the same float32 values, so the instance
    does not depend on the machine or the device.  ``device`` is the card
    unless the caller asks for ``device='cpu'``; without a card the
    default raises, as torch does for a CUDA tensor.

    ``info``: 'identity' or 'natural' (``diag(1/sigma_t^2 x3,
    1/sigma_r^2 x3)``, the weighting real g2o graphs carry).

    Returns dict(nodes=SE3[N] noisy initial poses, edges=int64[E, 2],
    poses=SE3[E] measurements, infos=[E, 6, 6], gt=SE3[N]).

    Example:
        >>> from pypose_tpu_torch.datasets import synthetic_sphere
        >>> ds = synthetic_sphere(100, device='cpu')
        >>> tuple(ds['nodes'].lshape), tuple(ds['edges'].shape)
        ((100,), (179, 2))
    """
    n = n_poses
    idx = np.arange(n)
    z = 1.0 - 2.0 * (idx + 0.5) / n
    phi = np.arccos(z)
    theta = np.pi * (1 + 5 ** 0.5) * idx
    xyz = radius * np.stack([np.sin(phi) * np.cos(theta),
                             np.sin(phi) * np.sin(theta),
                             np.cos(phi)], axis=-1)
    yaw = np.arctan2(np.diff(xyz[:, 1], append=xyz[0:1, 1]),
                     np.diff(xyz[:, 0], append=xyz[0:1, 0]))
    rpy = np.stack([np.zeros(n), np.zeros(n), yaw], axis=-1)
    work = torch.float64
    rot = euler2SO3(torch.as_tensor(rpy, dtype=work)).tensor()
    gt = SE3(torch.cat([torch.as_tensor(xyz, dtype=work), rot], dim=-1))

    n_loops = int(loops_per_pose * n)
    rng = np.random.default_rng(seed)
    li = rng.integers(0, n, n_loops)
    stride = int(np.sqrt(n) * np.pi)
    lj = (li + stride) % n
    keep = li != lj
    ii = np.concatenate([idx[:-1], li[keep]])
    jj = np.concatenate([idx[1:], lj[keep]])
    edges = torch.as_tensor(np.stack([ii, jj], axis=1), dtype=torch.int64)

    E = edges.shape[0]
    gen = torch.Generator().manual_seed(seed)
    noise = randn_SE3(E, sigma=meas_sigma, generator=gen, dtype=work)
    Z = (gt[edges[:, 0]].Inv() @ gt[edges[:, 1]]) @ noise
    init_noise = randn_SE3(n, sigma=init_sigma, generator=gen, dtype=work)
    nodes = (init_noise @ gt).tensor().clone()
    nodes[0] = gt.tensor()[0]
    if info == 'natural':
        st, sr = meas_sigma
        diag = torch.tensor([1.0 / st ** 2] * 3 + [1.0 / sr ** 2] * 3,
                            dtype=dtype)
        infos = torch.diag(diag).expand(E, 6, 6)
    elif info == 'identity':
        infos = torch.eye(6, dtype=dtype).expand(E, 6, 6)
    else:
        raise ValueError(f"info must be 'identity' or 'natural', got "
                         f'{info!r}')
    return dict(nodes=SE3(nodes, dtype=dtype, device=device),
                edges=edges.to(device),
                poses=Z.to(device=device, dtype=dtype),
                infos=infos.to(device),
                gt=gt.to(device=device, dtype=dtype))
