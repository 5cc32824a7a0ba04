r"""g2o pose-graph files and the synthetic sphere pose graph.

Counterpart of ``pypose_tpu/datasets.py:20-150, 266-345``.  ``load_g2o`` is
the pure-Python parse of ``pypose_tpu/datasets.py:120-150``; the native
C++ tokenizer of the JAX package waits for a later slice.
``synthetic_sphere`` rebuilds the JAX generator's topology and ground truth
exactly but draws its noise from a ``torch.Generator``, so its problems
are not the JAX package's: the sphere2500 headline reads the JAX instance
from ``data/synthetic_sphere2500_seed42.g2o`` instead.
"""

import os

import numpy as np
import torch

from .lietensor.convert import euler2SO3
from .lietensor.utils import SE3, randn_SE3


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


def load_g2o(path, dtype=torch.float32, device=None):
    """Parse a g2o file with VERTEX_SE3:QUAT / EDGE_SE3:QUAT records.

    Vertices are sorted by id and edges renumbered to rows.  Returns
    dict(nodes=SE3[N], edges=int64[E, 2], poses=SE3[E] relative
    measurements, infos=[E, 6, 6] information matrices), all on
    ``device``.
    """
    verts, vids = [], []
    eii, ejj, emeas, einfo = [], [], [], []
    iu = np.triu_indices(6)
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == 'VERTEX_SE3:QUAT':
                vids.append(int(tok[1]))
                verts.append([float(x) for x in tok[2:9]])
            elif tok[0] == 'EDGE_SE3:QUAT':
                eii.append(int(tok[1]))
                ejj.append(int(tok[2]))
                emeas.append([float(x) for x in tok[3:10]])
                info = np.zeros((6, 6))
                info[iu] = [float(x) for x in tok[10:31]]
                einfo.append(info + np.triu(info, 1).T)
    order = np.argsort(vids)
    id2row = {vids[i]: r for r, i in enumerate(order)}
    nodes = np.asarray(verts)[order]
    edges = np.stack([[id2row[i] for i in eii],
                      [id2row[j] for j in ejj]], axis=1)
    return dict(
        nodes=SE3(torch.as_tensor(nodes, dtype=dtype, device=device)),
        edges=torch.as_tensor(edges, dtype=torch.int64, device=device),
        poses=SE3(torch.as_tensor(np.asarray(emeas), dtype=dtype,
                                  device=device)),
        infos=torch.as_tensor(np.stack(einfo), dtype=dtype, device=device),
    )


def synthetic_sphere(n_poses=2500, radius=25.0, loops_per_pose=0.8,
                     meas_sigma=(0.05, 0.02), init_sigma=(1.0, 0.3),
                     seed=42, dtype=torch.float32, info='identity',
                     device=None):
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
    does not depend on the machine or the device.

    ``info``: 'identity' or 'natural' (``diag(1/sigma_t^2 x3,
    1/sigma_r^2 x3)``, the weighting real g2o graphs carry).

    Returns dict(nodes=SE3[N] noisy initial poses, edges=int64[E, 2],
    poses=SE3[E] measurements, infos=[E, 6, 6], gt=SE3[N]).

    Example:
        >>> from pypose_tpu_torch.datasets import synthetic_sphere
        >>> ds = synthetic_sphere(100)
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
