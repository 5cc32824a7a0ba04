r"""Type checks.  Counterpart of ``pypose_tpu/function/checking.py:11-18``."""

from ..lietensor.lietensor import LieTensor, SE3_type


def is_lietensor(obj):
    return isinstance(obj, LieTensor)


def is_SE3(obj):
    """True for an SE3 LieTensor (by its ``ltype``)."""
    return getattr(obj, 'ltype', None) is SE3_type
