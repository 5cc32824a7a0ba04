r"""g2o pose-graph files: locate, write and parse.

Counterpart of ``pypose_tpu/datasets.py:20-150``.  ``load_g2o`` is the
pure-Python parse of ``pypose_tpu/datasets.py:120-150``; the native C++
tokenizer of the JAX package waits for a later slice.  The synthetic
generators stay in the JAX package: they draw their noise with
``jax.random``, so the port reads the problems they make from files
(``data/synthetic_sphere2500_seed42.g2o``).
"""

import os

import numpy as np
import torch

from .lietensor.utils import SE3


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
