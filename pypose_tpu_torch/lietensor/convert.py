r"""Conversions into and out of LieTensors.

Counterpart of ``pypose_tpu/lietensor/convert.py:24-350``: ``mat2SO3``,
``mat2SE3``, ``mat2Sim3``, ``mat2RxSO3`` and their checks, ``from_matrix``,
``euler2SO3``, the part accessors and ``quat2unit``.
"""

import warnings

import torch

from .lietensor import (LieTensor, SO3_type, SE3_type, Sim3_type, RxSO3_type,
                        liegroup)


def _check_shape(mat):
    mat = torch.as_tensor(mat)
    if mat.ndim < 2:
        raise ValueError('Input size must be at least 2 dimensions. Got '
                         f'{tuple(mat.shape)}')
    if tuple(mat.shape[-2:]) not in ((3, 3), (3, 4), (4, 4)):
        raise ValueError('Input size must be a * x 3 x 3 or * x 3 x 4 or '
                         f'* x 4 x 4 tensor. Got {tuple(mat.shape)}')
    return mat


def _check_rotation(mat, rtol, atol):
    e0 = mat @ mat.mT
    e1 = torch.eye(3, dtype=mat.dtype, device=mat.device).expand(e0.shape)
    if not torch.allclose(e0, e1, rtol=rtol, atol=atol):
        raise ValueError('Input rotation matrices are not all orthogonal '
                         'matrix')
    det = torch.linalg.det(mat)
    if not torch.allclose(det, torch.ones_like(det), rtol=rtol, atol=atol):
        raise ValueError("Input rotation matrices' determinant are not all "
                         "equal to 1")


def mat2SO3(mat, check=True, rtol=1e-5, atol=1e-5):
    r"""Rotation matrices ``(*, 3, 3)`` (or the upper-left block of
    ``(*, 3, 4)`` / ``(*, 4, 4)``) to SO3 quaternions ``(*, 4)``.

    The four-branch extraction (one branch per dominant diagonal term) is
    mask-combined, as in the JAX package, so every branch is computed and
    the masks pick one.  With ``check`` it raises ``ValueError`` unless the
    matrices are orthogonal with unit determinant within ``rtol``/``atol``
    (a host read on a CUDA tensor).

    Example:
        >>> import torch
        >>> from pypose_tpu_torch.lietensor.convert import mat2SO3
        >>> mat2SO3(torch.eye(3)).tensor()
        tensor([0., 0., 0., 1.])
    """
    mat = _check_shape(mat)[..., :3, :3]
    if check:
        _check_rotation(mat, rtol, atol)
    rt = mat.mT

    mask_d2 = rt[..., 2, 2] < atol
    mask_d0_d1 = rt[..., 0, 0] > rt[..., 1, 1]
    mask_d0_nd1 = rt[..., 0, 0] < -rt[..., 1, 1]

    t0 = 1 + rt[..., 0, 0] - rt[..., 1, 1] - rt[..., 2, 2]
    q0 = torch.stack([rt[..., 1, 2] - rt[..., 2, 1], t0,
                      rt[..., 0, 1] + rt[..., 1, 0],
                      rt[..., 2, 0] + rt[..., 0, 2]], dim=-1)
    t1 = 1 - rt[..., 0, 0] + rt[..., 1, 1] - rt[..., 2, 2]
    q1 = torch.stack([rt[..., 2, 0] - rt[..., 0, 2],
                      rt[..., 0, 1] + rt[..., 1, 0], t1,
                      rt[..., 1, 2] + rt[..., 2, 1]], dim=-1)
    t2 = 1 - rt[..., 0, 0] - rt[..., 1, 1] + rt[..., 2, 2]
    q2 = torch.stack([rt[..., 0, 1] - rt[..., 1, 0],
                      rt[..., 2, 0] + rt[..., 0, 2],
                      rt[..., 1, 2] + rt[..., 2, 1], t2], dim=-1)
    t3 = 1 + rt[..., 0, 0] + rt[..., 1, 1] + rt[..., 2, 2]
    q3 = torch.stack([t3, rt[..., 1, 2] - rt[..., 2, 1],
                      rt[..., 2, 0] - rt[..., 0, 2],
                      rt[..., 0, 1] - rt[..., 1, 0]], dim=-1)

    c0 = (mask_d2 & mask_d0_d1)[..., None].to(mat.dtype)
    c1 = (mask_d2 & ~mask_d0_d1)[..., None].to(mat.dtype)
    c2 = (~mask_d2 & mask_d0_nd1)[..., None].to(mat.dtype)
    c3 = (~mask_d2 & ~mask_d0_nd1)[..., None].to(mat.dtype)

    q = q0 * c0 + q1 * c1 + q2 * c2 + q3 * c3
    t = t0[..., None] * c0 + t1[..., None] * c1 + t2[..., None] * c2 \
        + t3[..., None] * c3
    q = q / (2.0 * torch.sqrt(t.clamp_min(torch.finfo(mat.dtype).tiny)))
    return LieTensor(q[..., [1, 2, 3, 0]], ltype=SO3_type)    # wxyz -> xyzw


def _check_last_row(mat, rtol, atol):
    zo = torch.tensor([0., 0., 0., 1.], dtype=mat.dtype, device=mat.device)
    if not torch.allclose(mat[..., 3, :], zo.expand(mat[..., 3, :].shape),
                          rtol=rtol, atol=atol):
        warnings.warn(
            'input of shape 4x4 last rows are not all equal [0, 0, 0, 1]')


def _translation_column(mat):
    if mat.shape[-1] == 3:
        return mat.new_zeros(mat.shape[:-2] + (3,))
    return mat[..., :3, 3]


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _scale_and_rotation(mat, check, rtol, atol):
    """Scale ``det(sR)^(1/3)`` [*, 1] and the de-scaled block's quaternion
    [*, 4]; raises if the block is not full rank (a host read)."""
    rot = mat[..., :3, :3]
    s = _cbrt(torch.linalg.det(rot))[..., None]
    if torch.allclose(s, torch.zeros_like(s), rtol=rtol, atol=atol):
        raise ValueError('Rotation matrix not full rank.')
    q = mat2SO3(rot / s[..., None], check=check, rtol=rtol, atol=atol)
    return s, q.tensor()


def mat2SE3(mat, check=True, rtol=1e-5, atol=1e-5):
    r"""Transformation matrices ``(*, 3|4, 3|4)`` to SE3 ``(*, 7)``: the
    rotation block through :func:`mat2SO3`, the translation from the
    fourth column (zeros for 3x3 input).  With ``check``, a 4x4 input whose
    last row is not ``[0, 0, 0, 1]`` warns.

    Example:
        >>> import torch
        >>> from pypose_tpu_torch.lietensor.convert import mat2SE3
        >>> M = torch.eye(4)
        >>> M[:3, 3] = torch.tensor([1., 2., 3.])
        >>> mat2SE3(M).tensor()
        tensor([1., 2., 3., 0., 0., 0., 1.])
    """
    mat = _check_shape(mat)
    if tuple(mat.shape[-2:]) == (4, 4) and check:
        _check_last_row(mat, rtol, atol)
    q = mat2SO3(mat[..., :3, :3], check=check, rtol=rtol, atol=atol).tensor()
    return LieTensor(torch.cat([_translation_column(mat), q], dim=-1),
                     ltype=SE3_type)


def mat2Sim3(mat, check=True, rtol=1e-5, atol=1e-5):
    r"""Similarity matrices ``(*, 3|4, 3|4)`` to Sim3 ``(*, 8)``: the scale
    is ``det(sR)^(1/3)``, the de-scaled block goes through :func:`mat2SO3`.

    Example:
        >>> import torch
        >>> from pypose_tpu_torch.lietensor.convert import mat2Sim3
        >>> mat2Sim3(2.0 * torch.eye(3)).tensor()
        tensor([0., 0., 0., 0., 0., 0., 1., 2.])
    """
    mat = _check_shape(mat)
    if tuple(mat.shape[-2:]) == (4, 4) and check:
        _check_last_row(mat, rtol, atol)
    s, q = _scale_and_rotation(mat, check, rtol, atol)
    return LieTensor(torch.cat([_translation_column(mat), q, s], dim=-1),
                     ltype=Sim3_type)


def mat2RxSO3(mat, check=True, rtol=1e-5, atol=1e-5):
    r"""Scaled rotations ``(*, 3, 3)`` to RxSO3 ``(*, 5)``.

    Example:
        >>> import torch
        >>> from pypose_tpu_torch.lietensor.convert import mat2RxSO3
        >>> mat2RxSO3(3.0 * torch.eye(3)).tensor()
        tensor([0., 0., 0., 1., 3.])
    """
    s, q = _scale_and_rotation(_check_shape(mat), check, rtol, atol)
    return LieTensor(torch.cat([q, s], dim=-1), ltype=RxSO3_type)


def from_matrix(mat, ltype, check=True, rtol=1e-5, atol=1e-5):
    """Matrix to LieTensor of the group ``ltype``."""
    to = {SO3_type: mat2SO3, SE3_type: mat2SE3, Sim3_type: mat2Sim3,
          RxSO3_type: mat2RxSO3}.get(ltype)
    if to is None:
        raise ValueError('Input ltype must be one of SO3_type, SE3_type, '
                         f'Sim3_type or RxSO3_type. Got {ltype}')
    return to(mat, check=check, rtol=rtol, atol=atol)


def euler2SO3(euler, dtype=None, device=None):
    r"""Euler angles ``(*, 3)`` (roll, pitch, yaw; radians) to SO3, in the
    intrinsic x-y-z convention of the JAX package and pypose.

    Example:
        >>> import torch
        >>> from pypose_tpu_torch.lietensor.convert import euler2SO3
        >>> euler2SO3(torch.zeros(3)).tensor()
        tensor([0., 0., 0., 1.])
    """
    euler = torch.as_tensor(euler, dtype=dtype, device=device)
    if euler.shape[-1] != 3:
        raise ValueError(f'euler angles need a last dim of 3, got '
                         f'{tuple(euler.shape)}')
    roll, pitch, yaw = euler.unbind(-1)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    q = torch.stack([sr * cp * cy - cr * sp * sy,
                     cr * sp * cy + sr * cp * sy,
                     cr * cp * sy - sr * sp * cy,
                     cr * cp * cy + sr * sp * sy], dim=-1)
    return LieTensor(q, ltype=SO3_type)


def tensor(inputs):
    """Storage tensor of a LieTensor."""
    return inputs.tensor()


def translation(inputs):
    """Translation part ``(*, 3)`` (zeros for SO3/RxSO3)."""
    return inputs.translation()


def rotation(inputs):
    """Rotation part as an SO3 LieTensor."""
    return inputs.rotation()


def scale(inputs):
    """Scale part ``(*, 1)`` (ones for SO3/SE3)."""
    return inputs.scale()


def matrix(inputs):
    """Dense matrix form: 3x3 (SO3/RxSO3) or 4x4 (SE3/Sim3)."""
    return inputs.matrix()


def euler(inputs, eps=2e-4):
    """Roll, pitch, yaw of the rotation part (``LieTensor.euler``)."""
    return inputs.euler(eps=eps)


def quat2unit(input, eps=1e-12):
    """Normalize the quaternion part of a group LieTensor; anything else
    warns and is returned as it is."""
    if not (isinstance(input, LieTensor) and input.ltype in liegroup):
        warnings.warn('Input is not Lie group, doing nothing and returning '
                      'input.')
        return input
    data = input.tensor()
    a = 0 if input.ltype in (SO3_type, RxSO3_type) else 3
    q = data[..., a:a + 4]
    n = torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(eps)
    return LieTensor(torch.cat([data[..., :a], q / n, data[..., a + 4:]],
                               dim=-1), ltype=input.ltype)
