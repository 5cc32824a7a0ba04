r"""Trajectory evaluation: absolute and relative pose error (APE, RPE).

Counterpart of ``pypose_tpu/metric/ape_rpe.py:18-315``.  Timestamps,
association and pair selection stay on the host in numpy, as in the JAX
package; the poses stay on their tensor's device and are indexed there
with index tensors built from the host's index lists, and the error
statistics are torch reductions on that device.

Two places hold the JAX package's rules where torch's would differ:
``Median`` is the mean of the two middle values of an even count (the
JAX package's ``jnp.median``; ``torch.median`` takes the lower one), and
``STD`` has one degree of freedom removed.  :func:`matching_time_indices`
finds each nearest timestamp by a binary search over the sorted stamps
(O(n log n)) instead of the JAX package's dense ``[n1, n2]`` distance
matrix (1 GB at 3,600 x 36,000 stamps); it picks the same index, ties to
the lowest, as that matrix's ``argmin``.
"""

import warnings

import numpy as np
import torch

from ..function.geometry import svdstf
from ..lietensor.convert import mat2SO3
from ..lietensor.lietensor import SE3_type, Sim3_type
from ..lietensor.utils import SE3, Sim3, identity_Sim3


def _host(x):
    return x.detach().cpu().numpy()


class StampedSE3:
    """Timestamped SE3 trajectory: poses (an SE3 LieTensor of one batch
    dimension, on any device) and float64 numpy timestamps (frame numbers
    when ``timestamps`` is None), ascending."""

    def __init__(self, timestamps=None, poses_SE3=None, dtype=None):
        assert poses_SE3 is not None, 'The pose must be not None'
        assert poses_SE3.tensor().numel() != 0, 'The pose must be not empty'
        assert len(poses_SE3.lshape) == 1, \
            'Only one trajectory estimation is supported'
        self.poses = poses_SE3 if dtype is None else poses_SE3.to(dtype)
        if timestamps is None:
            self.timestamps = np.arange(poses_SE3.lshape[0],
                                        dtype=np.float64)
        else:
            self.timestamps = np.asarray(timestamps, dtype=np.float64)
        assert self.timestamps.ndim == 1, \
            'The timestamp should be one array'
        assert self.timestamps.shape[0] == self.poses.lshape[0], \
            'timestamps and poses must have same length'
        assert np.all(np.sort(self.timestamps) == self.timestamps), \
            'timestamps must be ascending'

    def _rows(self, index):
        if isinstance(index, list):
            index = np.asarray(index, dtype=np.int64)
        if isinstance(index, np.ndarray):
            return index, torch.as_tensor(index, device=self.poses.device)
        return index, index

    def __getitem__(self, index):
        host, dev = self._rows(index)
        return StampedSE3(self.timestamps[host], self.poses[dev])

    def reduce_to_ids(self, ids):
        host, dev = self._rows(ids)
        self.timestamps = self.timestamps[host]
        self.poses = self.poses[dev]

    def align(self, trans):
        """Apply an SE3 or a Sim3 alignment (a Sim3 through the poses
        lifted to Sim3 with scale 1)."""
        if trans.ltype is SE3_type:
            self.poses = trans @ self.poses
        elif trans.ltype is Sim3_type:
            data = self.poses.tensor()
            poses_sim = Sim3(torch.cat([data, torch.ones_like(data[..., :1])],
                                       dim=-1))
            self.poses = SE3((trans @ poses_sim).tensor()[..., 0:7])

    def translation(self):
        return self.poses.translation()

    def rotation(self):
        return self.poses.rotation()

    @property
    def num_poses(self):
        return self.poses.shape[0]

    @property
    def first_pose(self):
        return self.poses[0]

    @property
    def dtype(self):
        return self.poses.dtype

    @property
    def accumulated_distances(self):
        """Path length at each pose (numpy, float64 after a cumulative
        sum in the poses' dtype, as the JAX package computes it)."""
        trans = _host(self.translation())
        norm = np.linalg.norm(trans[:-1] - trans[1:], axis=-1)
        return np.concatenate([np.zeros(1), np.cumsum(norm)])


def matching_time_indices(stamps_1, stamps_2, max_diff=0.01, offset_2=0.0):
    """For each stamp of ``stamps_1``, the nearest of ``stamps_2 +
    offset_2`` (ties to the lowest index); the pairs closer than
    ``max_diff`` as two index lists."""
    stamps_1 = np.asarray(stamps_1, dtype=np.float64)
    stamps_2 = np.asarray(stamps_2, dtype=np.float64) + offset_2
    order = np.argsort(stamps_2, kind='stable')
    s2 = stamps_2[order]
    n2 = len(s2)
    hi = np.searchsorted(s2, stamps_1, side='left')
    lo = np.maximum(hi - 1, 0)
    hi = np.minimum(hi, n2 - 1)
    d_lo = np.abs(stamps_1 - s2[lo])
    d_hi = np.abs(stamps_1 - s2[hi])
    # the lowest original index holding each candidate's value (a stable
    # sort puts it first among equal values)
    i_lo = order[np.searchsorted(s2, s2[lo], side='left')]
    i_hi = order[np.searchsorted(s2, s2[hi], side='left')]
    pick = np.where(d_lo < d_hi, i_lo,
                    np.where(d_hi < d_lo, i_hi, np.minimum(i_lo, i_hi)))
    value = np.minimum(d_lo, d_hi)
    indices_1 = np.arange(len(stamps_1))
    keep = value < max_diff
    return indices_1[keep].tolist(), pick[keep].tolist()


def associate_traj(rtraj, etraj, max_diff=0.01, offset_2=0.0, threshold=0.3):
    """Associate two trajectories by nearest timestamps; warns when fewer
    than ``threshold`` of the shorter one's poses find a partner."""
    snd_longer = len(etraj.timestamps) > len(rtraj.timestamps)
    traj_long = etraj if snd_longer else rtraj
    traj_short = rtraj if snd_longer else etraj
    max_pairs = len(traj_short.timestamps)
    m_short, m_long = matching_time_indices(
        traj_short.timestamps, traj_long.timestamps, max_diff,
        offset_2 if snd_longer else -offset_2)
    assert len(m_short) == len(m_long), \
        'matching_time_indices returned unequal number of indices'
    num_matches = len(m_long)
    assert num_matches != 0, \
        f'found no matching timestamps with max diff {max_diff} (s) ' \
        f'and offset {offset_2} (s)'
    traj_short = traj_short[m_short]
    traj_long = traj_long[m_long]
    rtraj_aligned = traj_short if snd_longer else traj_long
    etraj_aligned = traj_long if snd_longer else traj_short
    if num_matches < threshold * max_pairs:
        warnings.warn('The estimated trajectory has not enough timestamps '
                      'within the GT timestamps; results may be inaccurate.',
                      category=Warning, stacklevel=2)
    return rtraj_aligned, etraj_aligned


def _median(x):
    """The JAX package's median: the mean of the two middle values of an
    even count, ``(low + high) * 0.5``."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def compute_error(rtraj, etraj, output='translation', mtype='ape',
                  otype='All'):
    """Error statistics of two associated trajectories: a dict of 0-d
    tensors (Max, Min, Mean, Median, RMSE, SSE, STD) for ``otype='All'``,
    else the one named."""
    E = None
    if mtype == 'ape':
        if output == 'translation':
            E = etraj.translation() - rtraj.translation()
        else:
            E = (etraj.poses.Inv() @ rtraj.poses).matrix()
    elif mtype == 'rpe':
        E = (rtraj.poses.Inv() @ etraj.poses).matrix()

    if output == 'translation':
        if mtype == 'ape':
            error = torch.linalg.norm(E, dim=-1)
        else:
            error = torch.linalg.norm(E[..., :3, 3], dim=-1)
    elif output == 'rotation':
        I = torch.eye(3, dtype=E.dtype, device=E.device)
        error = torch.linalg.norm(E[:, :3, :3] - I, dim=(-2, -1))
    elif output == 'pose':
        I = torch.eye(4, dtype=E.dtype, device=E.device)
        error = torch.linalg.norm(E - I, dim=(-2, -1))
    elif output in ('radian', 'degree'):
        error = torch.linalg.norm(
            mat2SO3(E[:, :3, :3], check=False).Log().tensor(), dim=-1)
        if output == 'degree':
            error = torch.rad2deg(error)
    else:
        raise ValueError(f'Unknown output type: {output}')

    options = ['All', 'Max', 'Min', 'Mean', 'Median', 'RMSE', 'SSE', 'STD']
    if otype not in options:
        raise ValueError(f'Unknown output metric type, select one in '
                         f'{options}')
    err = torch.abs(error)
    results = {
        'Max': torch.max(err),
        'Min': torch.min(err),
        'Mean': torch.mean(err),
        'Median': _median(err),
        'RMSE': torch.sqrt(torch.mean(error ** 2)),
        'SSE': torch.sum(error ** 2),
        'STD': torch.std(err, correction=1),
    }
    return results if otype == 'All' else results[otype]


def pairs_by_frames(traj, delta, all=False):
    """Pose pairs ``delta`` frames apart: every one (``all``) or one
    chain of consecutive ones."""
    traj_len = traj.num_poses
    delta = int(delta)
    assert delta >= 1, 'delta must >= 1'
    if all:
        ids_1 = np.arange(traj_len)
        ids_2 = ids_1 + delta
        keep = ids_2 < traj_len
        return ids_1[keep].tolist(), ids_2[keep].tolist()
    ids = np.arange(0, traj_len, delta)
    return ids[:-1].tolist(), ids[1:].tolist()


def pairs_by_dist(traj, delta, tol=0.0, all=False):
    """Pose pairs ``delta`` of path length apart: from every pose to the
    one nearest ``delta`` further on, within ``tol`` (``all``), or one
    chain of poses each at least ``delta`` past the last."""
    if all:
        idx_0, idx_1 = [], []
        distances = traj.accumulated_distances
        for i in range(len(distances) - 1):
            offset = i + 1
            dist_from_here = distances[offset:] - distances[i]
            cand = int(np.argmin(np.abs(dist_from_here - delta)))
            if abs(dist_from_here[cand] - delta) > tol:
                continue
            idx_0.append(i)
            idx_1.append(cand + offset)
        return idx_0, idx_1
    idx = []
    trans = _host(traj.translation())
    prev = trans[0]
    current_path = 0.0
    for i, cur in enumerate(trans):
        current_path += float(np.linalg.norm(cur - prev))
        prev = cur
        if current_path >= delta:
            idx.append(i)
            current_path = 0.0
    return idx[:-1], idx[1:]


def pair_id(traj, delta=1.0, associate='frame', rtol=0.1, all=False):
    """The RPE's pose pairs, by frames or by distance (``rtol`` of
    ``delta`` the tolerance); raises for an empty list."""
    if associate == 'frame':
        id_pairs = pairs_by_frames(traj, int(delta), all)
    elif associate == 'distance':
        id_pairs = pairs_by_dist(traj, delta, delta * rtol, all)
    else:
        raise ValueError(f'unsupported delta unit: {associate}')
    if len(id_pairs[0]) == 0:
        raise ValueError(
            f'delta = {delta} ({associate}) produced an empty index list - '
            'try lower values or a less strict tolerance')
    return id_pairs


def _aligned(rstamp, rpose, estamp, epose, diff, offset, align, scale,
             nposes, origin, thresh):
    """Associate the two trajectories, then align the estimate: Umeyama
    (``svdstf``, SE3 or with ``scale`` Sim3) over its first ``nposes``
    positions, or its first pose onto the reference's (``origin``)."""
    rtraj, etraj = StampedSE3(rstamp, rpose), StampedSE3(estamp, epose)
    rtraj, etraj = associate_traj(rtraj, etraj, diff, offset, thresh)
    trans_mat = identity_Sim3(1, dtype=etraj.dtype,
                              device=etraj.poses.device)
    if align or scale:
        nposes = etraj.num_poses if nposes == -1 else nposes
        trans_mat = svdstf(etraj.translation()[:nposes],
                           rtraj.translation()[:nposes], scale)
    elif origin:
        first = (rtraj.first_pose @ etraj.first_pose.Inv()).tensor()
        data = trans_mat.tensor().clone()
        data[..., :7] = first
        trans_mat = Sim3(data)
    etraj.align(trans_mat)
    return rtraj, etraj


def ape(rstamp=None, rpose=None, estamp=None, epose=None,
        etype='translation', diff=0.01, offset=0.0, align=False, scale=False,
        nposes=-1, origin=False, thresh=0.3, otype='All'):
    r"""Absolute pose error between a reference and an estimated
    trajectory, after nearest-timestamp association and optionally SE3
    (``align=True``) or Sim3 (``scale=True``) Umeyama alignment, or the
    first poses made equal (``origin=True``).

    Args:
        rstamp, rpose: reference timestamps (numpy, or None for frame
            numbers) and SE3 poses.
        estamp, epose: the estimated trajectory.
        etype: 'translation' | 'rotation' | 'pose' | 'radian' | 'degree'.
        otype: 'All' for the dict of statistics (Max, Min, Mean, Median,
            RMSE, SSE, STD) or one statistic's name.

    Returns:
        the dict of 0-d tensors on the poses' device, or the one named.

    Example:
        >>> import torch, pypose_tpu_torch as pp
        >>> pose = pp.randn_SE3(20, sigma=0.1,
        ...                     generator=torch.Generator().manual_seed(0))
        >>> stats = pp.metric.ape(rpose=pose, epose=pose)   # identical
        >>> round(float(stats['RMSE']), 6)
        0.0
    """
    rtraj, etraj = _aligned(rstamp, rpose, estamp, epose, diff, offset,
                            align, scale, nposes, origin, thresh)
    return compute_error(rtraj, etraj, etype, mtype='ape', otype=otype)


def rpe(rstamp=None, rpose=None, estamp=None, epose=None,
        etype='translation', diff=0.01, offset=0.0, align=False, scale=False,
        nposes=-1, origin=False, associate='frame', delta=1.0, rtol=0.1,
        all=False, thresh=0.3, rpair=False, otype='All'):
    r"""Relative pose error: the error of relative motions
    :math:`P_i^{-1} P_j` over pose pairs chosen by frames
    (``associate='frame'``) or by path length (``associate='distance'``)
    on the estimate (or on the reference, ``rpair=True``), after the same
    association and alignment as :func:`ape`.

    Example:
        >>> import torch, pypose_tpu_torch as pp
        >>> pose = pp.randn_SE3(20, sigma=0.1,
        ...                     generator=torch.Generator().manual_seed(0))
        >>> stats = pp.metric.rpe(rpose=pose, epose=pose, delta=1.0)
        >>> round(float(stats['Max']), 6)
        0.0
    """
    rtraj, etraj = _aligned(rstamp, rpose, estamp, epose, diff, offset,
                            align, scale, nposes, origin, thresh)
    sour_id, tar_id = pair_id(rtraj if rpair else etraj, delta, associate,
                              rtol, all)
    src, tar = rtraj[sour_id], rtraj[tar_id]
    rpose_rela = src.poses.Inv() @ tar.poses
    esrc, etar = etraj[sour_id], etraj[tar_id]
    epose_rela = esrc.poses.Inv() @ etar.poses
    rtraj_rela = StampedSE3(src.timestamps, rpose_rela)
    etraj_rela = StampedSE3(esrc.timestamps, epose_rela)
    return compute_error(rtraj_rela, etraj_rela, etype, mtype='rpe',
                         otype=otype)
