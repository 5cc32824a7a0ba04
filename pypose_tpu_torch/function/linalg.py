r"""Batched linear-algebra helpers.

Counterpart of ``pypose_tpu/function/linalg.py``.
"""

import torch

from ..lietensor.lietensor import LieTensor


def _t(x):
    return x.tensor() if isinstance(x, LieTensor) else x


def bvv(lvec, rvec):
    """Batched vector-vector outer product ``(*, m), (*, n) -> (*, m, n)``.

    Ref: pypose_tpu/function/linalg.py:12.

    Example:
        >>> import torch, pypose_tpu_torch as pp
        >>> pp.bvv(torch.tensor([1., 2.]), torch.tensor([3., 4.]))
        tensor([[3., 4.],
                [6., 8.]])
    """
    lvec, rvec = _t(lvec), _t(rvec)
    return lvec[..., :, None] @ rvec[..., None, :]


def bmv(mat, vec):
    """Batched matrix-vector product ``(*, m, n), (*, n) -> (*, m)``.

    Ref: pypose_tpu/function/linalg.py:27.

    Example:
        >>> import torch, pypose_tpu_torch as pp
        >>> pp.bmv(torch.eye(2) * 2., torch.tensor([1., 3.]))
        tensor([2., 6.])
    """
    mat, vec = _t(mat), _t(vec)
    assert mat.dim() >= 2 and vec.dim() >= 1, 'Input arguments invalid'
    assert mat.shape[-1] == vec.shape[-1], 'matrix-vector shape invalid'
    return (mat @ vec[..., None])[..., 0]


def bvmv(lvec, mat, rvec):
    """Batched vector-matrix-vector product ``-> (*,)``, at least 1-d
    (a quadratic form).

    Ref: pypose_tpu/function/linalg.py:43.

    Example:
        >>> import torch, pypose_tpu_torch as pp
        >>> pp.bvmv(torch.ones(2), torch.eye(2), torch.ones(2))
        tensor([2.])
    """
    lvec, mat, rvec = _t(lvec), _t(mat), _t(rvec)
    assert mat.dim() >= 2 and lvec.dim() >= 1 and rvec.dim() >= 1
    assert lvec.shape[-1] == mat.shape[-2] and \
        mat.shape[-1] == rvec.shape[-1]
    out = (lvec[..., None, :] @ mat @ rvec[..., :, None])[..., 0, 0]
    return torch.atleast_1d(out)
