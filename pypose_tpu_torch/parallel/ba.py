r"""Bundle adjustment with the observations sharded over a mesh axis:
:class:`ShardedBA`.

Counterpart of ``pypose_tpu/parallel/__init__.py:450-522``.  Every rank
holds an equal slice of the camera-sorted (padded) observations and the
full camera and point state; each sum over observations (the camera and
point sums of the rhs, the Hessian blocks, each Schur matvec, chi2 and the
predicted reduction) is a partial sum over the rank's observations and
one ``all_reduce`` over the axis.  The dense reduced camera system is a
sum over points: each rank forms the Gram of its share of the points
and the partial Grams are all-reduced.
"""

import numpy as np
import torch

from ..optim.ba import BundleAdjustment, _gram_cols
from ..optim.strategy import Constant
from .mesh import (all_reduce_sum, axis_size, check_device, local_rows,
                   make_mesh)


class ShardedBA(BundleAdjustment):
    """:class:`~pypose_tpu_torch.optim.ba.BundleAdjustment` with its
    observations sharded over the mesh axis ``axis``, with the full LM
    semantics (strategy, reject loop, robust kernels) and both Schur modes.

    Observations pad to a multiple of the axis size with zero-focal
    cameras: their residual ``f * distortion * p - pixel`` is 0 - 0 and
    every Jacobian term scales by f = 0, so they add nothing, and the
    ``obs_valid`` mask (permuted with the camera sort by ``_obs_perm``)
    keeps them out of chi2 under robust kernels.  The camera sums take the
    incidence and gather forms (``_cam_win = None``).  ``damping`` selects
    a ``Constant`` strategy.  The tensors must lie on the mesh's device
    type.  Ref: pypose_tpu/parallel/__init__.py:450-522.
    """

    def __init__(self, poses, points, cam_idx, pt_idx, pixels, cameras,
                 mesh=None, axis='dp', damping=None, strategy=None, **kw):
        self.mesh = make_mesh() if mesh is None else mesh
        check_device(self.mesh, poses.tensor(), points, pixels, cameras)
        if strategy is None and damping is not None:
            strategy = Constant(damping=damping)
        C = poses.lshape[0]
        dev = points.device
        cam_idx = torch.as_tensor(cam_idx, dtype=torch.int64, device=dev)
        pt_idx = torch.as_tensor(pt_idx, dtype=torch.int64, device=dev)
        if cameras.shape[0] == C:
            cameras = cameras[cam_idx]
        O = pixels.shape[0]
        m = axis_size(self.mesh, axis)
        pad = (-O) % m
        valid = None
        if pad:
            zi = cam_idx.new_zeros(pad)
            cam_idx, pt_idx = torch.cat([cam_idx, zi]), torch.cat([pt_idx, zi])
            pixels = torch.cat([pixels, pixels.new_zeros((pad, 2))])
            cameras = torch.cat(
                [cameras, cameras.new_zeros((pad,) + cameras.shape[1:])])
            valid = np.concatenate([np.ones(O, bool), np.zeros(pad, bool)])
        super().__init__(poses, points, cam_idx, pt_idx, pixels, cameras,
                         strategy=strategy, **kw)
        self._group = self.mesh.get_group(axis)
        # the whole problem's point tables and camera indices, for the
        # dense Schur pieces
        self._pt_inc_all, self._cam_idx_all = self._pt_inc, self.cam_idx
        O_pad = O + pad
        r = self.mesh.get_local_rank(axis)
        self._obs_rows = (r * (O_pad // m), O_pad // m, O_pad)
        p_per = -(-self.P // m)
        self._pt_rows = (min(r * p_per, self.P), min((r + 1) * p_per, self.P))

        def local(x):
            return local_rows(x, self.mesh, axis)

        self.cam_idx, self.pt_idx = local(self.cam_idx), local(self.pt_idx)
        self.pixels, self.cameras = local(self.pixels), local(self.cameras)
        if valid is not None:
            self.obs_valid = local(torch.as_tensor(valid[self._obs_perm],
                                                   device=dev))
        self._ci = self.cam_idx.cpu().numpy()
        self._pi = self.pt_idx.cpu().numpy()
        # tables of the rank's own observations; no camera windows
        self._build_point_incidence()
        self._cam_win = None

    def _reduce(self, sums):
        return all_reduce_sum(sums, self._group)

    def _acc_cams(self, obs, contrib):
        return self._reduce(super()._acc_cams(obs, contrib))

    def _acc_points(self, obs, contrib):
        return self._reduce(super()._acc_points(obs, contrib))

    def _dense_pieces(self, obs, Jc, Jp):
        """The whole problem's coupling blocks gathered per point: the
        rank's [O / m, 18] rows placed in a zero-filled [O, 18] and
        all-reduced (exact), then the point tables of every
        observation."""
        start, n, O = self._obs_rows
        G18 = _gram_cols(Jc, Jp).reshape(-1, 18)
        full = G18.new_zeros((O, 18))
        full[start:start + n] = G18
        full = self._reduce(full)
        inc, incm = self._pt_inc_all
        return full[inc] * incm[..., None], self._cam_idx_all[inc], incm

    def _schur_M(self, Hpp_inv, Gp18, cam_slot, incm):
        """The Gram of the rank's share of the points, all-reduced."""
        p0, p1 = self._pt_rows
        return self._reduce(super()._schur_M(
            Hpp_inv[p0:p1], Gp18[p0:p1], cam_slot[p0:p1], incm[p0:p1]))

    def run(self, steps):
        """``steps`` LM iterations in one ``optimize`` call (stops early
        only on a rejected step that makes no progress); returns the final
        chi2."""
        return self.optimize(steps=steps, patience=steps + 1,
                             decreasing=-float('inf'))
