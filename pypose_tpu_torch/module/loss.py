r"""Geodesic rotation loss.  Counterpart of ``pypose_tpu/module/loss.py``."""

import torch

from ..nn import Module
from ..function.checking import is_lietensor


def geodesic_loss(input, target, reduction='mean'):
    r"""Rotation geodesic distance :math:`\|\mathrm{Log}(x\,y^{-1})\|`
    between the rotation parts of two group LieTensors, with 'none' |
    'mean' | 'sum' reduction.

    Ref: pypose_tpu/module/loss.py:9-38.

    Example:
        >>> import torch, pypose_tpu_torch as pp
        >>> q = pp.randn_SO3(4, generator=torch.Generator().manual_seed(0))
        >>> bool(pp.geodesic_loss(q, q) < 1e-6)
        True
    """
    if not (is_lietensor(input) and is_lietensor(target)):
        raise TypeError('input and target should be LieTensors')
    if reduction not in ('none', 'mean', 'sum'):
        raise ValueError(f'reduction type not supported: {reduction!r}')
    x, y = input.rotation(), target.rotation()
    e = x * y.Inv()
    if not e.ltype.on_manifold:
        e = e.Log()
    theta = torch.linalg.norm(e.tensor(), dim=-1)
    if reduction == 'none':
        return theta
    if reduction == 'mean':
        return theta.mean()
    return theta.sum()


class GeodesicLoss(Module):
    r""":func:`geodesic_loss` as a module.  Ref:
    pypose_tpu/module/loss.py:41-47."""

    def __init__(self, reduction='mean'):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, target):
        return geodesic_loss(input, target, self.reduction)
