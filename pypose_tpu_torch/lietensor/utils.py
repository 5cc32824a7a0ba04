r"""LieTensor constructors and identity factories for SO3/so3/SE3/se3.

Counterpart of ``pypose_tpu/lietensor/utils.py:42-200``.  The random
factories (``utils.py:126-174``) take an explicit ``torch.Generator`` where
the JAX package takes a ``jax.random`` key; they never read torch's global
stream.  Both give different numbers from the same seed.
"""

import torch

from .lietensor import LieTensor, SO3_type, so3_type, SE3_type, se3_type


def _constructor(ltype, name):
    def ctor(data, dtype=None, device=None):
        return LieTensor(data, ltype=ltype, dtype=dtype, device=device)
    ctor.__name__ = name
    ctor.__doc__ = f"""Construct a {name}-type LieTensor from storage
    ``data`` of shape ``(*, {ltype.dimension[0]})``."""
    return ctor


def _identity_factory(ltype, name):
    def fn(*lsize, dtype=torch.float32, device=None):
        return ltype.identity(*lsize, dtype=dtype, device=device)
    fn.__name__ = name
    fn.__doc__ = f"""Identity {ltype.name} LieTensor with batch shape
    ``lsize`` (the identity transform for a group, zero for an algebra)."""
    return fn


SO3 = _constructor(SO3_type, 'SO3')
so3 = _constructor(so3_type, 'so3')
SE3 = _constructor(SE3_type, 'SE3')
se3 = _constructor(se3_type, 'se3')

identity_SO3 = _identity_factory(SO3_type, 'identity_SO3')
identity_so3 = _identity_factory(so3_type, 'identity_so3')
identity_SE3 = _identity_factory(SE3_type, 'identity_SE3')
identity_se3 = _identity_factory(se3_type, 'identity_se3')


def _randn_factory(ltype, name):
    def fn(*lsize, sigma=1.0, generator=None, dtype=torch.float32,
           device=None):
        return ltype.randn(*lsize, sigma=sigma, generator=generator,
                           dtype=dtype, device=device)
    fn.__name__ = name
    fn.__doc__ = f"""Random {ltype.name} LieTensor with batch shape
    ``lsize``, drawn from ``generator`` (a ``torch.Generator``, required)
    on the generator's device and then moved to ``device``.  ``sigma`` is
    as in ``pypose_tpu.{name}``."""
    return fn


randn_so3 = _randn_factory(so3_type, 'randn_so3')
randn_SO3 = _randn_factory(SO3_type, 'randn_SO3')
randn_se3 = _randn_factory(se3_type, 'randn_se3')
randn_SE3 = _randn_factory(SE3_type, 'randn_SE3')
