r"""Iterative Closest Point.

Counterpart of ``pypose_tpu/module/icp.py:27-132``: nearest-neighbour
association (``knn``), Kabsch (``svdtf``) and composition, under
``ReduceToBason``'s stop rules.  The JAX package runs the loop as one
``lax.while_loop`` program (or, with a verbose stepper, on the host);
torch has no such loop, so here the sweeps run on the host and the
stepper reads the sweep's error once per sweep.  The returned value is
the loop's composition; its gradient is the JAX package's straight-through
Kabsch surrogate on the converged correspondences
(``icp.py:108-116``).
"""

import torch

from ..function.checking import is_SE3
from ..function.geometry import knn, svdtf
from ..lietensor.lietensor import LieTensor, SE3_type
from ..utils.stepper import ReduceToBason


def _matched(targetb, knnidx, shape):
    """Each point's nearest target point, ``shape + (3,)``."""
    idx = knnidx[..., 0].expand(shape)
    return torch.gather(targetb, -2, idx[..., None].expand(shape + (3,)))


class ICP(torch.nn.Module):
    r"""Batched Iterative Closest Point: the SE3 aligning ``source``
    ``(*, N, 3)`` to ``target`` ``(*, M, 3)``, batch dims broadcast.

    Args:
        stepper: loop controller (default ``ReduceToBason(steps=200)``).
        init: optional SE3 LieTensor applied to ``source`` first (also an
            argument of :meth:`forward`, which takes precedence).

    Example:
        >>> import torch
        >>> import pypose_tpu_torch as ppt
        >>> from pypose_tpu_torch.module import ICP
        >>> gen = torch.Generator().manual_seed(0)
        >>> src = torch.randn((60, 3), generator=gen)
        >>> T = ppt.randn_SE3(sigma=(0.2, 0.1), generator=gen)
        >>> T_est = ICP()(src, T.Act(src))
        >>> bool((T_est.Inv() @ T).Log().tensor().abs().max() < 1e-2)
        True
    """

    def __init__(self, stepper=None, init=None):
        super().__init__()
        self.stepper = ReduceToBason(steps=200) if stepper is None \
            else stepper
        if init is not None and not is_SE3(init):
            raise TypeError('The initial transformation is not SE3Type.')
        self.init = init

    def forward(self, source, target, ord=2, dim=-1, init=None):
        init = init if init is not None else self.init
        batch = torch.broadcast_shapes(source.shape[:-2], target.shape[:-2])
        shape = batch + source.shape[-2:-1]
        targetb = target.expand(batch + target.shape[-2:])
        st = self.stepper
        st.reset()
        with torch.no_grad():
            temporal = source.detach()
            if init is not None:
                if not is_SE3(init):
                    raise TypeError('The initial transformation is not '
                                    'SE3Type LieTensor.')
                temporal = init.detach().unsqueeze(-2) @ temporal
            while st.continual():
                knndist, knnidx = knn(temporal, target, k=1, ord=ord,
                                      dim=dim)
                T = svdtf(temporal, _matched(targetb, knnidx, shape))
                temporal = T.unsqueeze(-2) @ temporal
                st.step(knndist[..., 0].mean(dim=-1))
            # value: the loop's composition; gradient: one Kabsch on the
            # converged correspondences (straight-through)
            T_val = svdtf(source, temporal).tensor()
            _, knnidx = knn(temporal, target, k=1, ord=ord, dim=dim)
        T_diff = svdtf(source, _matched(targetb, knnidx, shape)).tensor()
        return LieTensor(T_diff + (T_val - T_diff).detach(), ltype=SE3_type)
