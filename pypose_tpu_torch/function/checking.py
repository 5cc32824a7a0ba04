r"""Type and NaN checks.  Counterpart of
``pypose_tpu/function/checking.py:11-31``."""

import math

import torch

from ..lietensor.lietensor import LieTensor, SE3_type


def is_lietensor(obj):
    return isinstance(obj, LieTensor)


def is_SE3(obj):
    """True for an SE3 LieTensor (by its ``ltype``)."""
    return getattr(obj, 'ltype', None) is SE3_type


def hasnan(obj):
    """True if a tensor, LieTensor or number, or any of them inside a
    (nested) list, tuple or dict, holds a NaN.  Reads the host once for
    each tensor.  Ref: pypose_tpu/function/checking.py:21-31."""
    if isinstance(obj, (list, tuple)):
        return any(hasnan(v) for v in obj)
    if isinstance(obj, dict):
        return any(hasnan(v) for v in obj.values())
    if isinstance(obj, LieTensor):
        obj = obj.tensor()
    if torch.is_tensor(obj):
        return bool(torch.isnan(obj).any())
    return math.isnan(obj)
