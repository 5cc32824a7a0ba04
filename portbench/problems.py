"""The benchmark's inputs, made here and handed to both the program and
the reference: a plain g2o parser, a frozen copy of the port's sphere
generator (``pypose_tpu_torch/datasets.py:synthetic_sphere``) and of its
Sim3 lift (``pypose_tpu_torch/testing:pgo_group_instance``), and the
instance checksum the anchor files carry (``testing.instance_checksum``).

Everything is drawn in float64 on the CPU from the seed and then rounded
to float32, the precision the configurations state, so one seed gives one
instance on every machine.  A graph is a dict of float64 CPU tensors
holding the float32-rounded values: ``nodes [N, 8]`` and ``meas [E, 8]``
as (t, q, s) poses, s = 1 for SE3, and ``edges [E, 2]``.
"""

import gzip

import numpy as np
import torch

from reference import lie


def parse_g2o(path):
    """VERTEX_SE3:QUAT and EDGE_SE3:QUAT records (other lines are
    skipped); vertices sorted by id and edges renumbered to rows.  The
    information matrices are not read: every configuration here is
    unweighted and the file's are identity."""
    opener = gzip.open if str(path).endswith('.gz') else open
    ids, verts, edges, meas = [], [], [], []
    with opener(path, 'rt') as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == 'VERTEX_SE3:QUAT':
                ids.append(int(tok[1]))
                verts.append([float(x) for x in tok[2:9]])
            elif tok[0] == 'EDGE_SE3:QUAT':
                edges.append((int(tok[1]), int(tok[2])))
                meas.append([float(x) for x in tok[3:10]])
    ids = np.asarray(ids)
    order = np.argsort(ids)
    edges = np.searchsorted(ids[order], np.asarray(edges))
    return _graph(torch.as_tensor(np.asarray(verts)[order]),
                  torch.as_tensor(edges), torch.as_tensor(np.asarray(meas)))


def _graph(nodes7, edges, meas7):
    """A graph dict from SE3 (t, q) storage, rounded to float32."""
    def pose(x):
        x = x.to(torch.float32).to(torch.float64)
        return torch.cat([x, torch.ones_like(x[:, :1])], -1)
    return {'nodes': pose(nodes7), 'edges': edges.to(torch.int64),
            'meas': pose(meas7)}


def _euler_quat(rpy):
    """Intrinsic x-y-z Euler angles to a quaternion (x, y, z, w)."""
    roll, pitch, yaw = rpy.unbind(-1)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    return torch.stack([sr * cp * cy - cr * sp * sy,
                        cr * sp * cy + sr * cp * sy,
                        cr * cp * sy - sr * sp * cy,
                        cr * cp * cy + sr * sp * sy], -1)


def _randn_se3(n, sigma_t, sigma_r, gen):
    """Exp of se3 noise: a random axis times an N(0, sigma_r) angle
    (drawn first), then N(0, sigma_t) translation, as the port draws."""
    axis = torch.randn((n, 3), generator=gen, dtype=torch.float64)
    dist = torch.linalg.norm(axis, dim=-1, keepdim=True).clamp_min(
        torch.finfo(torch.float64).tiny)
    angle = sigma_r * torch.randn((n, 1), generator=gen, dtype=torch.float64)
    trans = sigma_t * torch.randn((n, 3), generator=gen, dtype=torch.float64)
    return lie.exp(torch.cat([trans, axis / dist * angle], -1), 'SE3')


def sphere(n_poses, seed, radius=25.0, loops_per_pose=0.8,
           meas_sigma=(0.05, 0.02), init_sigma=(1.0, 0.3)):
    """The sphere-world pose graph of ``synthetic_sphere`` (identity
    information): poses on a golden-angle spiral, odometry i -> i+1 and
    ``int(loops_per_pose n)`` loop closures i -> i + int(sqrt(n) pi) from
    ``np.random.default_rng(seed)``; measurement and initial-pose noise
    from ``torch.Generator().manual_seed(seed)``; pose 0 at the truth."""
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
    rpy = torch.as_tensor(np.stack([np.zeros(n), np.zeros(n), yaw], -1))
    one = torch.ones(n, 1, dtype=torch.float64)
    gt = torch.cat([torch.as_tensor(xyz), _euler_quat(rpy), one], -1)

    rng = np.random.default_rng(seed)
    li = rng.integers(0, n, int(loops_per_pose * n))
    lj = (li + int(np.sqrt(n) * np.pi)) % n
    keep = li != lj
    edges = torch.as_tensor(np.stack([np.concatenate([idx[:-1], li[keep]]),
                                      np.concatenate([idx[1:], lj[keep]])],
                                     1))
    E = edges.shape[0]
    gen = torch.Generator().manual_seed(seed)
    noise = _randn_se3(E, *meas_sigma, gen)
    Z = lie.compose(lie.compose(lie.inverse(gt[edges[:, 0]]),
                                gt[edges[:, 1]]), noise)
    nodes = lie.compose(_randn_se3(n, *init_sigma, gen), gt)
    nodes[0] = gt[0]
    return _graph(nodes[:, :7], edges, Z[:, :7])


def lift_sim3(graph, seed, scale_sigma=0.05):
    """The graph over Sim3: poses and measurements with scale 1, then
    each initial pose's scale times ``exp(scale_sigma N(0, 1))`` drawn in
    float64 from ``torch.Generator().manual_seed(seed)`` and rounded to
    float32."""
    gen = torch.Generator().manual_seed(seed)
    s = torch.exp(scale_sigma * torch.randn(
        (graph['nodes'].shape[0], 1), generator=gen, dtype=torch.float64))
    nodes = graph['nodes'].clone()
    nodes[:, 7:8] = s.to(torch.float32).to(torch.float64)
    return dict(graph, nodes=nodes)


def storage(graph, group):
    """(nodes, meas) as the port stores them: SE3 (t, q) [., 7], Sim3
    (t, q, s) [., 8]."""
    k = 8 if group == 'Sim3' else 7
    return graph['nodes'][:, :k], graph['meas'][:, :k]


def checksum(graph, group):
    """float64 sums of |nodes| and |meas| in the port's storage, and the
    edge count: the anchor files' ``instance_checksum``."""
    nodes, meas = storage(graph, group)
    return {'nodes_abs_sum': float(nodes.abs().sum()),
            'poses_abs_sum': float(meas.abs().sum()),
            'n_edges': int(graph['edges'].shape[0])}


def build(config, traffic, seed, root):
    """The cell's graph: the configuration's pose graph (a g2o file under
    ``root`` or the sphere generator at ``seed``), lifted to the
    traffic's group."""
    g = config['graph']
    if g['kind'] == 'g2o':
        graph = parse_g2o(root / g['file'])
    elif g['kind'] == 'sphere':
        graph = sphere(g['n_poses'], seed, g['radius'], g['loops_per_pose'],
                       tuple(g['meas_sigma']), tuple(g['init_sigma']))
    else:
        raise ValueError(f"graph kind {g['kind']!r}")
    if traffic['group'] == 'Sim3':
        graph = lift_sim3(graph, seed, traffic['scale_sigma'])
    elif traffic['group'] != 'SE3':
        raise ValueError(f"group {traffic['group']!r}")
    return graph
