r"""LieTensor for torch: a storage tensor plus a static group type.

Counterpart of ``pypose_tpu/lietensor/lietensor.py:32-340, 502-815``.  As
in the JAX package, ``LieTensor`` is a thin wrapper (not a ``torch.Tensor``
subclass): the storage tensor holds the data and ``ltype`` says which group
or algebra it is.  All four groups (SO3, SE3, RxSO3, Sim3) and their
algebras, their operations differentiable through the autograd Functions
of ``operation.py``, with the random factories
(``randn``, ``pypose_tpu/lietensor/lietensor.py:215-217, 258-268,
314-330, 377-394, 442-454``) on an explicit ``torch.Generator`` and the
batch-dim views ICP uses (``unsqueeze``, ``squeeze``, ``expand``,
``view``, ``lview``); ``Act`` and ``@`` broadcast a ``[..., 1, 7]`` SE3
against ``[..., N, 3]`` points, and take homogeneous 4-points too.

``LieTensor`` is a torch pytree node (``torch.utils._pytree``; its
storage the leaf, its ``ltype`` the context), as it is a JAX pytree node
in the JAX package, so ``torch.func.vmap``, ``jacrev``, ``jacfwd`` and
``grad`` take and return LieTensors with their ltype kept.
"""

from numbers import Number

import torch
import torch.utils._pytree as pytree

from . import operation as op
from .jacobian import so3_Jr


class LieType:
    """Per-group static metadata and op dispatch.  An operation a type
    does not have raises ``AttributeError``."""

    def __init__(self, name, dimension, embedding, manifold):
        self._name = name
        self._dimension = (dimension,)
        self._embedding = (embedding,)
        self._manifold = (manifold,)

    @property
    def name(self):
        return self._name

    @property
    def dimension(self):
        return self._dimension

    @property
    def embedding(self):
        return self._embedding

    @property
    def manifold(self):
        return self._manifold

    @property
    def on_manifold(self):
        return self._dimension == self._manifold

    def __repr__(self):
        return self._name + 'Type'

    def _missing(self, name):
        raise AttributeError(f'{self} has no {name} attribute')

    def Exp(self, x):
        self._missing('Exp')

    def Log(self, X):
        self._missing('Log')

    def Inv(self, X):
        self._missing('Inv')

    def Act(self, X, p):
        self._missing('Act')

    def Mul(self, X, Y):
        self._missing('Mul')

    def Retr(self, X, a):
        self._missing('Retr')

    def Adj(self, X, a):
        self._missing('Adj')

    def AdjT(self, X, a):
        self._missing('AdjT')

    def Jinvp(self, X, p):
        self._missing('Jinvp')

    def Jr(self, X):
        raise NotImplementedError(f'{self} has no Jr attribute')

    def add(self, X, other, alpha=1):
        self._missing('add')

    def matrix(self, X):
        self._missing('matrix')

    def rotation(self, X):
        raise NotImplementedError(
            'Rotation is not implemented for the instance.')

    def translation(self, X):
        return X.tensor().new_zeros(X.lshape + (3,))

    def scale(self, X):
        return X.tensor().new_ones(X.lshape + (1,))

    def identity_like(self, X):
        return self.identity(*X.lshape, dtype=X.dtype, device=X.device)

    def randn_like(self, X, sigma=1.0, generator=None):
        return self.randn(*X.lshape, sigma=sigma, generator=generator,
                          dtype=X.dtype, device=X.device)

    def identity(self, *size, dtype=torch.float32, device=None):
        self._missing('identity')

    def randn(self, *size, sigma=1.0, generator=None, dtype=torch.float32,
              device=None):
        self._missing('randn')

    @staticmethod
    def to_tuple(size):
        out = ()
        for i in size:
            out += tuple(i) if isinstance(i, (tuple, list, torch.Size)) \
                else (i,)
        return out


def _data(x):
    return x.tensor() if isinstance(x, LieTensor) else x


def _normal(generator, size, dtype):
    """Standard normal draws on the generator's own device.  JAX keys
    become an explicit generator: there is no global stream to fall back
    on."""
    if not isinstance(generator, torch.Generator):
        raise TypeError('randn needs generator=torch.Generator(...); got '
                        f'{type(generator).__name__}')
    return torch.randn(size, generator=generator, dtype=dtype,
                       device=generator.device)


def _so3_randn(size, sigma, generator, dtype):
    """Random axis times an N(0, sigma) angle (JAX draws: axis, angle)."""
    if not isinstance(sigma, Number):
        raise TypeError('so3 randn takes sigma as a single number')
    data = _normal(generator, size + (3,), dtype)
    dist = torch.linalg.norm(data, dim=-1, keepdim=True).clamp_min(
        torch.finfo(dtype).tiny)
    theta = sigma * _normal(generator, size + (1,), dtype)
    return data / dist * theta


def _se3_randn(size, sigma, generator, dtype):
    """se3 noise with per-channel sigma: a number, ``(sigma_t, sigma_r)``
    or ``(sx, sy, sz, sigma_r)``; rotation drawn first, as in JAX."""
    if not isinstance(sigma, (tuple, list)):
        sigma = (sigma,) * 4
    elif len(sigma) == 2:
        sigma = (sigma[0],) * 3 + (sigma[1],)
    elif len(sigma) != 4:
        raise ValueError('se3 randn takes sigma of size 1, 2 or 4')
    rot = _so3_randn(size, sigma[-1], generator, dtype)
    t_sigma = torch.tensor(sigma[:3], dtype=dtype, device=generator.device)
    trans = t_sigma * _normal(generator, size + (3,), dtype)
    return torch.cat([trans, rot], dim=-1)


def _rxso3_randn(size, sigma, generator, dtype):
    """rxso3 noise: sigma a number or ``(sigma_r, sigma_s)``; rotation
    drawn first, then the log-scale, as in JAX."""
    if not isinstance(sigma, (tuple, list)):
        sigma = (sigma, sigma)
    elif len(sigma) != 2:
        raise ValueError('rxso3 randn takes sigma of size 1 or 2')
    rot = _so3_randn(size, sigma[0], generator, dtype)
    scale = sigma[1] * _normal(generator, size + (1,), dtype)
    return torch.cat([rot, scale], dim=-1)


def _sim3_randn(size, sigma, generator, dtype):
    """sim3 noise: sigma a number, ``(sigma_t, sigma_r, sigma_s)`` or
    ``(sx, sy, sz, sigma_r, sigma_s)``; drawn in JAX's order: rotation,
    log-scale, translation."""
    if not isinstance(sigma, (tuple, list)):
        sigma = (sigma,) * 5
    elif len(sigma) == 3:
        sigma = (sigma[0],) * 3 + (sigma[1], sigma[2])
    elif len(sigma) != 5:
        raise ValueError('sim3 randn takes sigma of size 1, 3 or 5')
    rot = _so3_randn(size, sigma[-2], generator, dtype)
    scale = sigma[-1] * _normal(generator, size + (1,), dtype)
    t_sigma = torch.tensor(sigma[:3], dtype=dtype, device=generator.device)
    trans = t_sigma * _normal(generator, size + (3,), dtype)
    return torch.cat([trans, rot, scale], dim=-1)


class _GroupType(LieType):
    """The four group types: dispatch to the ``operation`` functions.
    ``parts`` maps 'rotation', 'translation', 'scale' to the storage
    slices the group has (the others fall to the base class)."""

    def __init__(self, name, dimension, manifold, algebra_getter, ops,
                 identity, parts):
        super().__init__(name, dimension, dimension, manifold)
        self._algebra_getter = algebra_getter
        self._ops = ops
        self._identity = identity
        self._parts = parts

    @property
    def _algebra(self):
        return self._algebra_getter()

    def Log(self, X):
        return LieTensor(self._ops['Log'](_data(X)), ltype=self._algebra)

    def Act(self, X, p):
        p = _data(p)
        if p.shape[-1] not in (3, 4):
            raise ValueError('Act takes points of last dimension 3 or 4, '
                             f'got {tuple(p.shape)}')
        fn = self._ops['Act'] if p.shape[-1] == 3 else self._ops['Act4']
        return fn(_data(X), p)

    def Mul(self, X, Y):
        if isinstance(Y, LieTensor) and not Y.ltype.on_manifold:
            return LieTensor(self._ops['Mul'](_data(X), Y.tensor()),
                             ltype=self)
        if torch.is_tensor(Y):
            return self.Act(X, Y)
        raise NotImplementedError('Invalid __mul__ operation')

    def Inv(self, X):
        return LieTensor(self._ops['Inv'](_data(X)), ltype=self)

    def Retr(self, X, a):
        return a.Exp() * X

    def Adj(self, X, a):
        return LieTensor(self._ops['AdjXa'](_data(X), _data(a)),
                         ltype=self._algebra)

    def AdjT(self, X, a):
        return LieTensor(self._ops['AdjTXa'](_data(X), _data(a)),
                         ltype=self._algebra)

    def Jinvp(self, X, p):
        return LieTensor(self._ops['Jinvp'](_data(X), _data(p)),
                         ltype=self._algebra)

    def Jr(self, X):
        return X.Log().Jr()

    def matrix(self, X):
        return self._ops['Matrix'](_data(X))

    def rotation(self, X):
        return LieTensor(_data(X)[..., self._parts['rotation']],
                         ltype=SO3_type)

    def translation(self, X):
        part = self._parts.get('translation')
        return super().translation(X) if part is None \
            else _data(X)[..., part]

    def scale(self, X):
        part = self._parts.get('scale')
        return super().scale(X) if part is None else _data(X)[..., part]

    def add(self, X, other, alpha=1):
        """Left retraction: ``Exp(alpha * other[..., :m]) * X``."""
        m = self._manifold[0]
        delta = LieTensor(alpha * _data(other)[..., :m], ltype=self._algebra)
        return delta.Exp() * X

    def identity(self, *size, dtype=torch.float32, device=None):
        size = self.to_tuple(size)
        data = torch.tensor(self._identity, dtype=dtype, device=device)
        return LieTensor(data.expand(size + data.shape), ltype=self)

    def randn(self, *size, sigma=1.0, generator=None, dtype=torch.float32,
              device=None):
        """Exp of the algebra's randn, taken on the generator's device and
        then moved, so one CPU generator gives the same values anywhere."""
        x = self._algebra.randn(*size, sigma=sigma, generator=generator,
                                dtype=dtype)
        return LieTensor(x.Exp().tensor().to(device), ltype=self)


class _AlgebraType(LieType):
    """The four algebra types: Exp to the group; plain vector add, negation
    and scaling; identity is zero; matrix and parts through the group."""

    def __init__(self, name, dimension, embedding, group_getter, exp,
                 randn):
        super().__init__(name, dimension, embedding, dimension)
        self._group_getter = group_getter
        self._exp = exp
        self._randn = randn

    def Exp(self, x):
        return LieTensor(self._exp(_data(x)), ltype=self._group_getter())

    def add(self, X, other, alpha=1):
        m = self._manifold[0]
        return LieTensor(X.tensor() + alpha * _data(other)[..., :m],
                         ltype=self)

    def Inv(self, X):
        return LieTensor(-X.tensor(), ltype=self)

    def Mul(self, X, Y):
        """(number or tensor) * algebra element."""
        return LieTensor(X.tensor() * _data(Y), ltype=self)

    def Jr(self, x):
        """Right Jacobian Jl(-x); so3 only, as in the JAX package."""
        if self is not so3_type:
            return super().Jr(x)
        return so3_Jr(_data(x))

    def matrix(self, X):
        return X.Exp().matrix()

    def rotation(self, X):
        return X.Exp().rotation()

    def translation(self, X):
        return X.Exp().translation()

    def scale(self, X):
        return X.Exp().scale()

    def identity(self, *size, dtype=torch.float32, device=None):
        size = self.to_tuple(size)
        return LieTensor(torch.zeros(size + self._dimension, dtype=dtype,
                                     device=device), ltype=self)

    def randn(self, *size, sigma=1.0, generator=None, dtype=torch.float32,
              device=None):
        """Random algebra element, drawn on the generator's device and then
        moved to ``device``."""
        x = self._randn(self.to_tuple(size), sigma, generator, dtype)
        return LieTensor(x.to(device), ltype=self)


SO3_type = _GroupType(
    'SO3', 4, 3, lambda: so3_type,
    dict(Log=op.SO3_Log, Act=op.SO3_Act, Act4=op.SO3_Act4, Mul=op.SO3_Mul,
         Inv=op.SO3_Inv, AdjXa=op.SO3_AdjXa, AdjTXa=op.SO3_AdjTXa,
         Jinvp=op.SO3_Jinvp, Matrix=op.SO3_Matrix),
    [0., 0., 0., 1.], dict(rotation=slice(0, 4)))
so3_type = _AlgebraType('so3', 3, 4, lambda: SO3_type, op.so3_Exp,
                         _so3_randn)
SE3_type = _GroupType(
    'SE3', 7, 6, lambda: se3_type,
    dict(Log=op.SE3_Log, Act=op.SE3_Act, Act4=op.SE3_Act4, Mul=op.SE3_Mul,
         Inv=op.SE3_Inv, AdjXa=op.SE3_AdjXa, AdjTXa=op.SE3_AdjTXa,
         Jinvp=op.SE3_Jinvp, Matrix=op.SE3_Matrix),
    [0., 0., 0., 0., 0., 0., 1.],
    dict(rotation=slice(3, 7), translation=slice(0, 3)))
se3_type = _AlgebraType('se3', 6, 7, lambda: SE3_type, op.se3_Exp,
                         _se3_randn)
RxSO3_type = _GroupType(
    'RxSO3', 5, 4, lambda: rxso3_type,
    dict(Log=op.RxSO3_Log, Act=op.RxSO3_Act, Act4=op.RxSO3_Act4,
         Mul=op.RxSO3_Mul, Inv=op.RxSO3_Inv, AdjXa=op.RxSO3_AdjXa,
         AdjTXa=op.RxSO3_AdjTXa, Jinvp=op.RxSO3_Jinvp,
         Matrix=op.RxSO3_Matrix),
    [0., 0., 0., 1., 1.], dict(rotation=slice(0, 4), scale=slice(4, 5)))
rxso3_type = _AlgebraType('rxso3', 4, 5, lambda: RxSO3_type, op.rxso3_Exp,
                           _rxso3_randn)
Sim3_type = _GroupType(
    'Sim3', 8, 7, lambda: sim3_type,
    dict(Log=op.Sim3_Log, Act=op.Sim3_Act, Act4=op.Sim3_Act4,
         Mul=op.Sim3_Mul, Inv=op.Sim3_Inv, AdjXa=op.Sim3_AdjXa,
         AdjTXa=op.Sim3_AdjTXa, Jinvp=op.Sim3_Jinvp, Matrix=op.Sim3_Matrix),
    [0., 0., 0., 0., 0., 0., 1., 1.],
    dict(rotation=slice(3, 7), translation=slice(0, 3), scale=slice(7, 8)))
sim3_type = _AlgebraType('sim3', 7, 8, lambda: Sim3_type, op.sim3_Exp,
                          _sim3_randn)
liegroup = [SO3_type, SE3_type, Sim3_type, RxSO3_type]
liealgebra = [so3_type, se3_type, sim3_type, rxso3_type]


class LieTensor:
    r"""Lie-group / Lie-algebra tensor backed by a torch tensor.

    The last dimension is the group storage (see
    :mod:`pypose_tpu_torch.lietensor.operation` for layouts); all leading
    dimensions are batch dimensions (``lshape``).

    Example:
        >>> import torch
        >>> from pypose_tpu_torch.lietensor.utils import se3
        >>> X = se3(torch.tensor([[0.1, 0., 0., 0., 0., 0.3]])).Exp()
        >>> X.lshape, X.shape
        (torch.Size([1]), torch.Size([1, 7]))
        >>> bool(torch.allclose((X @ X.Inv()).Log().tensor(),
        ...                     torch.zeros(6), atol=1e-6))
        True
    """

    __slots__ = ('_data', '_ltype')

    def __init__(self, data, ltype=None, dtype=None, device=None):
        if isinstance(data, LieTensor):
            ltype = data.ltype if ltype is None else ltype
            data = data.tensor()
        if ltype is None:
            raise ValueError('ltype must be provided')
        self._data = torch.as_tensor(data, dtype=dtype, device=device)
        self._ltype = ltype

    @property
    def ltype(self):
        return self._ltype

    @property
    def shape(self):
        return self._data.shape

    @property
    def lshape(self):
        """Shape with the storage dimension hidden."""
        return self._data.shape[:-1]

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def device(self):
        return self._data.device

    def __len__(self):
        return self._data.shape[0]

    def tensor(self):
        """Underlying storage tensor."""
        return self._data

    def numpy(self):
        return self._data.detach().cpu().numpy()

    def __repr__(self):
        return f'{self._ltype} LieTensor:\n{self._data}'

    def to(self, *args, **kwargs):
        return LieTensor(self._data.to(*args, **kwargs), ltype=self._ltype)

    # -- batch-dim views (pypose_tpu/lietensor/lietensor.py:639-668) --------
    def _wrap(self, data):
        return LieTensor(data, ltype=self._ltype)

    def __getitem__(self, key):
        return self._wrap(self._data[key])

    def detach(self):
        return self._wrap(self._data.detach())

    def reshape(self, *shape):
        return self._wrap(self._data.reshape(LieType.to_tuple(shape)))

    def view(self, *shape):
        return self.reshape(*shape)

    def lview(self, *shape):
        """Reshape the batch dims only."""
        shape = LieType.to_tuple(shape)
        return self._wrap(self._data.reshape(shape + self._ltype.dimension))

    def unsqueeze(self, dim):
        return self._wrap(self._data.unsqueeze(dim))

    def squeeze(self, dim=None):
        return self._wrap(self._data.squeeze() if dim is None
                          else self._data.squeeze(dim))

    def expand(self, *shape):
        return self._wrap(self._data.expand(LieType.to_tuple(shape)))

    def broadcast_to(self, shape):
        return self._wrap(self._data.broadcast_to(tuple(shape)))

    def Exp(self):
        return self._ltype.Exp(self)

    def Log(self):
        return self._ltype.Log(self)

    def Inv(self):
        return self._ltype.Inv(self)

    def Act(self, p):
        return self._ltype.Act(self, p)

    def Adj(self, a):
        return self._ltype.Adj(self, a)

    def AdjT(self, a):
        return self._ltype.AdjT(self, a)

    def Jinvp(self, p):
        return self._ltype.Jinvp(self, p)

    def Jr(self):
        return self._ltype.Jr(self)

    def Retr(self, a):
        return self._ltype.Retr(self, a)

    def add(self, other, alpha=1):
        return self._ltype.add(self, other, alpha)

    def mul(self, other):
        return self._ltype.Mul(self, other)

    def matrix(self):
        return self._ltype.matrix(self)

    def rotation(self):
        return self._ltype.rotation(self)

    def translation(self):
        return self._ltype.translation(self)

    def scale(self):
        return self._ltype.scale(self)

    def identity_like(self):
        return self._ltype.identity_like(self)

    def euler(self, eps=2e-4):
        """Roll, pitch, yaw of the rotation part, with the gimbal-lock
        branch taken when |sin(pitch)| is within ``eps`` of 1
        (``pypose_tpu/lietensor/lietensor.py:732-750``)."""
        data = self.rotation().tensor()
        x, y, z, w = data.unbind(-1)
        xx, yy, zz, ww = x * x, y * y, z * z, w * w
        t0 = 2 * (w * x + y * z)
        t1 = (ww + zz) - (xx + yy)
        t2 = 2 * (w * y - z * x) / (xx + yy + zz + ww)
        t3 = 2 * (w * z + x * y)
        t4 = (ww + xx) - (yy + zz)
        flag = torch.abs(t2) < 1. - eps
        pm = torch.where(t2 >= 0, 1.0, -1.0)
        roll = torch.where(flag, torch.atan2(t0, t1), 0.0)
        pitch = torch.asin(torch.clamp(t2, -1, 1))
        yaw = torch.where(flag, torch.atan2(t3, t4),
                          -2 * pm * torch.atan2(x, w))
        return torch.stack([roll, pitch, yaw], dim=-1)

    def cumops(self, dim, ops):
        from ..basics.ops import cumops
        return cumops(self, dim, ops)

    def cummul(self, dim, left=True):
        from ..basics.ops import cummul
        return cummul(self, dim, left)

    def cumprod(self, dim, left=True):
        from ..basics.ops import cumprod
        return cumprod(self, dim, left)

    # the JAX package's in-place names alias the pure methods
    cumops_, cummul_, cumprod_ = cumops, cummul, cumprod

    def __add__(self, other):
        return self.add(other)

    def __neg__(self):
        if self._ltype.on_manifold:
            return self._wrap(-self._data)
        raise NotImplementedError('Lie Group has no __neg__; use Inv()')

    def __rmul__(self, other):
        if self._ltype.on_manifold and isinstance(other, Number):
            return self._ltype.Mul(self, other)
        raise NotImplementedError('Invalid __rmul__ operation')

    def __mul__(self, other):
        return self._ltype.Mul(self, other)

    def __matmul__(self, other):
        if isinstance(other, LieTensor):
            return self._ltype.Mul(self, other)
        return self.Act(other)


def _flatten(x):
    return [x._data], x._ltype


def _unflatten(children, ltype):
    """Rebuild without ``__init__``: a transform may put any leaf there (a
    batched tensor, or a nested LieTensor in a Jacobian)."""
    obj = object.__new__(LieTensor)
    obj._data = children[0]
    obj._ltype = ltype
    return obj


pytree.register_pytree_node(
    LieTensor, _flatten, _unflatten,
    serialized_type_name='pypose_tpu_torch.lietensor.LieTensor')
