r"""LieTensor for torch: a storage tensor plus a static group type.

Counterpart of ``pypose_tpu/lietensor/lietensor.py:32-340, 502-815``.  As
in the JAX package, ``LieTensor`` is a thin wrapper (not a ``torch.Tensor``
subclass): the storage tensor holds the data and ``ltype`` says which group
or algebra it is.  This slice covers SO3/so3/SE3/se3, forward only, with
the operations the pose-graph path uses, and the random factories
(``randn``, ``pypose_tpu/lietensor/lietensor.py:215-217, 258-268,
314-330``) on an explicit ``torch.Generator`` and the batch-dim views ICP
uses (``unsqueeze``, ``squeeze``, ``expand``, ``view``, ``lview``);
``Act`` and ``@`` broadcast a ``[..., 1, 7]`` SE3 against ``[..., N, 3]``
points.  RxSO3/rxso3/Sim3/sim3 exist
as types whose operations raise ``NotImplementedError`` until the
remaining-groups slice ports them.
"""

from numbers import Number

import torch

from . import operation as op


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

    def Adj(self, X, a):
        self._missing('Adj')

    def add(self, X, other, alpha=1):
        self._missing('add')

    def matrix(self, X):
        self._missing('matrix')

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


class _GroupType(LieType):
    """SO3 and SE3: dispatch to the ``operation`` functions."""

    def __init__(self, name, dimension, manifold, algebra_getter, ops,
                 identity):
        super().__init__(name, dimension, dimension, manifold)
        self._algebra_getter = algebra_getter
        self._ops = ops
        self._identity = identity

    @property
    def _algebra(self):
        return self._algebra_getter()

    def Log(self, X):
        return LieTensor(self._ops['Log'](_data(X)), ltype=self._algebra)

    def Act(self, X, p):
        p = _data(p)
        if p.shape[-1] != 3:
            raise NotImplementedError(
                'Act on homogeneous 4-points is not ported yet')
        return self._ops['Act'](_data(X), p)

    def Mul(self, X, Y):
        if isinstance(Y, LieTensor) and not Y.ltype.on_manifold:
            return LieTensor(self._ops['Mul'](_data(X), Y.tensor()),
                             ltype=self)
        if torch.is_tensor(Y):
            return self.Act(X, Y)
        raise NotImplementedError('Invalid __mul__ operation')

    def Inv(self, X):
        return LieTensor(self._ops['Inv'](_data(X)), ltype=self)

    def Adj(self, X, a):
        return LieTensor(self._ops['AdjXa'](_data(X), _data(a)),
                         ltype=self._algebra)

    def matrix(self, X):
        return self._ops['Matrix'](_data(X))

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
    """so3 and se3: Exp to the group; identity is zero."""

    def __init__(self, name, dimension, embedding, group_getter, exp,
                 randn):
        super().__init__(name, dimension, embedding, dimension)
        self._group_getter = group_getter
        self._exp = exp
        self._randn = randn

    def Exp(self, x):
        return LieTensor(self._exp(_data(x)), ltype=self._group_getter())

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


class _UnportedType(LieType):
    """RxSO3/Sim3 and their algebras: every operation raises until the
    remaining-groups slice (ROADMAP Queue A, slice 6) ports them."""

    def _missing(self, name):
        raise NotImplementedError(
            f'{self.name} is not ported yet (ROADMAP Queue A, slice 6: '
            'remaining groups)')


SO3_type = _GroupType(
    'SO3', 4, 3, lambda: so3_type,
    dict(Log=op.SO3_Log, Act=op.SO3_Act, Mul=op.SO3_Mul, Inv=op.SO3_Inv,
         AdjXa=op.SO3_AdjXa, Matrix=op.SO3_Matrix), [0., 0., 0., 1.])
so3_type = _AlgebraType('so3', 3, 4, lambda: SO3_type, op.so3_Exp,
                         _so3_randn)
SE3_type = _GroupType(
    'SE3', 7, 6, lambda: se3_type,
    dict(Log=op.SE3_Log, Act=op.SE3_Act, Mul=op.SE3_Mul, Inv=op.SE3_Inv,
         AdjXa=op.SE3_AdjXa, Matrix=op.SE3_Matrix),
    [0., 0., 0., 0., 0., 0., 1.])
se3_type = _AlgebraType('se3', 6, 7, lambda: SE3_type, op.se3_Exp,
                         _se3_randn)
RxSO3_type = _UnportedType('RxSO3', 5, 5, 4)
rxso3_type = _UnportedType('rxso3', 4, 5, 4)
Sim3_type = _UnportedType('Sim3', 8, 8, 7)
sim3_type = _UnportedType('sim3', 7, 8, 7)
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

    def add(self, other, alpha=1):
        return self._ltype.add(self, other, alpha)

    def matrix(self):
        return self._ltype.matrix(self)

    def __mul__(self, other):
        return self._ltype.Mul(self, other)

    def __matmul__(self, other):
        if isinstance(other, LieTensor):
            return self._ltype.Mul(self, other)
        return self.Act(other)
