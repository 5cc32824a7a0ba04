r"""Conversions into LieTensors.

Counterpart of ``pypose_tpu/lietensor/convert.py:239-268`` (``euler2SO3``);
the rest of that module comes with the remaining-groups slice.
"""

import torch

from .lietensor import LieTensor, SO3_type


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
