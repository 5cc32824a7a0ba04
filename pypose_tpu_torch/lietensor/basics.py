r"""Basic Lie functions: vec2skew, manifold-aware add, mul, and
stack/cat/split over batch dims.

Counterpart of ``pypose_tpu/lietensor/basics.py``.
"""

import numpy as np
import torch

from .jacobian import vec2skew as _vec2skew
from .lietensor import LieTensor


def _lie(x):
    if not isinstance(x, LieTensor):
        raise TypeError('input must be a LieTensor')
    return x


def vec2skew(input):
    r"""Batched vectors ``(*, 3)`` to skew-symmetric matrices ``(*, 3, 3)``.

    Example:
        >>> import torch
        >>> from pypose_tpu_torch.lietensor.basics import vec2skew
        >>> vec2skew(torch.tensor([1., 2., 3.]))
        tensor([[ 0., -3.,  2.],
                [ 3.,  0., -1.],
                [-2.,  1.,  0.]])
    """
    v = input.tensor() if isinstance(input, LieTensor) \
        else torch.as_tensor(input)
    if v.shape[-1] != 3:
        raise ValueError('Last dim should be 3')
    return _vec2skew(v)


def add(input, other, alpha=1):
    """Manifold-aware addition.  Algebra types: ``input + alpha * other``.
    Group types: ``Exp(alpha * other[..., :m]) * input`` with m the
    manifold dimension, so a storage-shaped ``other`` adds directly."""
    return _lie(input).add(other, alpha)


def add_(input, other, alpha=1):
    """Alias of :func:`add`: it returns the new value and leaves ``input``
    as it is, as the JAX package's does."""
    return add(input, other, alpha)


def mul(input, other):
    """Group composition, point action, or scaling of an algebra element,
    by the type of ``other``."""
    return _lie(input).mul(other)


def _same_ltype(tensors):
    lt = [t for t in tensors if isinstance(t, LieTensor)]
    if not lt:
        raise TypeError('At least one input must be a LieTensor')
    if any(t.ltype is not lt[0].ltype for t in lt):
        raise TypeError('ltype mismatch')
    return lt[0].ltype


def _datas(tensors):
    return [t.tensor() if isinstance(t, LieTensor) else torch.as_tensor(t)
            for t in tensors]


def stack(tensors, dim=0):
    """Stack LieTensors of one ltype along a new batch dim."""
    ltype = _same_ltype(tensors)
    return LieTensor(torch.stack(_datas(tensors), dim=dim), ltype=ltype)


def cat(tensors, dim=0):
    """Concatenate LieTensors of one ltype along an existing batch dim."""
    ltype = _same_ltype(tensors)
    return LieTensor(torch.cat(_datas(tensors), dim=dim), ltype=ltype)


concat = cat


def split(tensor, split_size_or_sections, dim=0):
    """Split a LieTensor along a batch dim, into chunks of a size or into
    the listed sections."""
    data = _lie(tensor).tensor()
    if not isinstance(split_size_or_sections, int):
        split_size_or_sections = [int(n) for n in
                                  np.asarray(split_size_or_sections)]
    return tuple(LieTensor(p, ltype=tensor.ltype)
                 for p in torch.split(data, split_size_or_sections, dim=dim))
