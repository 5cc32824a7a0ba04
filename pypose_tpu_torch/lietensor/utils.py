r"""LieTensor constructors, factories and the functional dispatch.

Counterpart of ``pypose_tpu/lietensor/utils.py:42-451``.  The random
factories (``utils.py:82-178``) take an explicit ``torch.Generator`` where
the JAX package takes a ``jax.random`` key; they never read torch's global
stream.  Both give different numbers from the same seed.
"""

import torch

from .lietensor import (LieTensor, SO3_type, so3_type, SE3_type, se3_type,
                        Sim3_type, sim3_type, RxSO3_type, rxso3_type)


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
Sim3 = _constructor(Sim3_type, 'Sim3')
sim3 = _constructor(sim3_type, 'sim3')
RxSO3 = _constructor(RxSO3_type, 'RxSO3')
rxso3 = _constructor(rxso3_type, 'rxso3')

identity_SO3 = _identity_factory(SO3_type, 'identity_SO3')
identity_so3 = _identity_factory(so3_type, 'identity_so3')
identity_SE3 = _identity_factory(SE3_type, 'identity_SE3')
identity_se3 = _identity_factory(se3_type, 'identity_se3')
identity_Sim3 = _identity_factory(Sim3_type, 'identity_Sim3')
identity_sim3 = _identity_factory(sim3_type, 'identity_sim3')
identity_RxSO3 = _identity_factory(RxSO3_type, 'identity_RxSO3')
identity_rxso3 = _identity_factory(rxso3_type, 'identity_rxso3')


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
randn_sim3 = _randn_factory(sim3_type, 'randn_sim3')
randn_Sim3 = _randn_factory(Sim3_type, 'randn_Sim3')
randn_rxso3 = _randn_factory(rxso3_type, 'randn_rxso3')
randn_RxSO3 = _randn_factory(RxSO3_type, 'randn_RxSO3')


def randn_like(input, sigma=1.0, generator=None):
    """Random LieTensor with ``input``'s ltype, lshape, dtype and device,
    drawn from ``generator``."""
    return input.ltype.randn_like(input, sigma=sigma, generator=generator)


def identity_like(input):
    """Identity LieTensor with ``input``'s ltype, lshape, dtype and device."""
    return input.ltype.identity_like(input)


# ---------------------------------------------------------------------------
# functional dispatch (pypose_tpu/lietensor/utils.py:194-451)
# ---------------------------------------------------------------------------

def _lie(x, name):
    if not isinstance(x, LieTensor):
        raise TypeError(f'Invalid LieTensor Type. To call {name}, the first '
                        'argument must be a LieTensor.')
    return x


def Exp(input):
    """Exponential map of an algebra-type LieTensor to its group."""
    return _lie(input, 'Exp').Exp()


def Log(input):
    """Logarithm map of a group-type LieTensor to its algebra."""
    return _lie(input, 'Log').Log()


def Inv(x):
    """Group inverse; an algebra element is negated."""
    return _lie(x, 'Inv').Inv()


def Mul(x, y):
    """``x * y``: composition with a group element, action on points
    ``(*, 3)`` or ``(*, 4)``, scaling of an algebra element."""
    return _lie(x, 'Mul') * y


def Retr(X, a):
    """Retraction ``Exp(a) * X`` (left perturbation)."""
    return _lie(X, 'Retr').Retr(a)


def Act(X, p):
    """Group action on points ``(*, 3)`` or homogeneous ``(*, 4)``."""
    return _lie(X, 'Act').Act(p)


def Adj(input, p):
    """``Adj(X) p``: ``X * Exp(p) = Exp(Adj(X, p)) * X``."""
    return _lie(input, 'Adj').Adj(p)


def AdjT(X, p):
    """``Adj(X^-1) p``: ``Exp(p) * X = X * Exp(AdjT(X, p))``."""
    return _lie(X, 'AdjT').AdjT(p)


def Jinvp(input, p):
    """``Jl^-1(Log(X)) p``."""
    return _lie(input, 'Jinvp').Jinvp(p)


def Jr(x):
    """Right Jacobian ``Jl(-x)`` of an so3 element (or of ``Log(X)``)."""
    return _lie(x, 'Jr').Jr()
