r"""LieTensor parameters in ``torch.nn`` modules.

Counterpart of ``pypose_tpu/nn.py``.  :class:`Module` is a
``torch.nn.Module``.  A LieTensor :class:`Parameter` keeps its ltype and
registers its storage as a ``torch.nn.Parameter``, so
``named_parameters()``, ``torch.optim``, ``.grad`` and
``torch.func.functional_call`` see an ordinary tensor, while the
attribute reads back as a LieTensor of that ltype.  The gradient of a
group-valued parameter follows the left-trivialized convention of
``lietensor/operation.py``: its first ``m`` entries are the left-tangent
gradient and its tail is zero, so a step is a retraction,
``X.Retr(-lr * X.grad)``, not a plain subtraction.

Example:
    >>> import torch
    >>> import pypose_tpu_torch as pp
    >>> class Pose(pp.Module):
    ...     def __init__(self):
    ...         super().__init__()
    ...         self.T = pp.Parameter(pp.identity_SE3(dtype=torch.float64))
    ...     def forward(self, p):
    ...         return self.T.Act(p)
    >>> m = Pose()
    >>> m(torch.ones(3, dtype=torch.float64)).sum().backward()
    >>> m.T.ltype, m.T.grad.shape, float(m.T.grad[-1])
    (SE3Type, torch.Size([7]), 0.0)
"""

import torch
import torch.utils._pytree as pytree

from .lietensor.lietensor import LieTensor


class Parameter(LieTensor):
    """A LieTensor whose storage is a ``torch.nn.Parameter``.

    ``Parameter(lietensor)`` keeps the ltype; ``Parameter(tensor)`` (no
    ltype) returns a ``torch.nn.Parameter``, a Euclidean parameter.
    """

    __slots__ = ()

    def __new__(cls, data=None, ltype=None, requires_grad=True):
        if not isinstance(data, LieTensor) and ltype is None:
            return torch.nn.Parameter(torch.as_tensor(data), requires_grad)
        return object.__new__(cls)

    def __init__(self, data=None, ltype=None, requires_grad=True):
        super().__init__(data, ltype=ltype)
        self._data = torch.nn.Parameter(self._data, requires_grad)

    @property
    def requires_grad(self):
        return self._data.requires_grad

    @property
    def grad(self):
        """The storage's gradient (left-tangent entries, zero tail)."""
        return self._data.grad


def _parameter_view(data, ltype):
    """The LieTensor a Lie parameter attribute reads as: a Parameter while
    the module holds its ``torch.nn.Parameter``, else (inside
    ``functional_call``) a LieTensor of the tensor swapped in."""
    obj = object.__new__(Parameter if isinstance(data, torch.nn.Parameter)
                         else LieTensor)
    obj._data = data
    obj._ltype = ltype
    return obj


pytree.register_pytree_node(
    Parameter, lambda x: ([x._data], x._ltype),
    lambda children, ltype: _parameter_view(children[0], ltype),
    serialized_type_name='pypose_tpu_torch.nn.Parameter')


class Module(torch.nn.Module):
    """``torch.nn.Module`` that also takes LieTensor :class:`Parameter`
    attributes: their storage is registered under the attribute's name
    and their ltype kept beside it."""

    def __init__(self):
        super().__init__()
        self._ltypes = {}

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self.register_parameter(name, value.tensor())
            self.__dict__.setdefault('_ltypes', {})[name] = value.ltype
            return
        super().__setattr__(name, value)

    def __getattr__(self, name):
        ltypes = self.__dict__.get('_ltypes', {})
        if name in ltypes:
            return _parameter_view(self._parameters[name], ltypes[name])
        return super().__getattr__(name)


def functional_call(module, params, args=(), kwargs=None):
    """``torch.func.functional_call`` with LieTensor values accepted in
    ``params`` (their storage is swapped in; the module's attribute reads
    it back with the parameter's ltype).

    Ref: pypose_tpu/nn.py:functional_call.
    """
    params = {k: v.tensor() if isinstance(v, LieTensor) else v
              for k, v in params.items()}
    if not isinstance(args, (tuple, list)):
        args = (args,)
    return torch.func.functional_call(module, params, tuple(args), kwargs)
