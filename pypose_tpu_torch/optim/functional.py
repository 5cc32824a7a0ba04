r"""Jacobians of a model's output with respect to its parameters.

Counterpart of ``pypose_tpu/optim/functional.py``: ``torch.func.jacrev``
and ``jacfwd`` over the parameters (in sorted name order, as the JAX
package's dict flattening gives them) through :func:`nn.functional_call`.
A LieTensor parameter's columns have its storage width, with the
left-tangent entries first and a zero tail (the convention of the Lie
core's autograd Functions).
"""

import torch

from ..lietensor.lietensor import LieTensor
from ..nn import functional_call


def _as_tensor(x):
    return x.tensor() if isinstance(x, LieTensor) else x


def _leaves(params):
    """(names, storage tensors, ltypes) in sorted name order, detached."""
    names = sorted(params)
    leaves = [_as_tensor(params[n]).detach() for n in names]
    ltypes = [params[n].ltype if isinstance(params[n], LieTensor) else None
              for n in names]
    return names, leaves, ltypes


def _rebuild(names, leaves, ltypes):
    return {n: LieTensor(v, ltype=lt) if lt is not None else v
            for n, v, lt in zip(names, leaves, ltypes)}


def _outputs(model, params, input):
    out = functional_call(model, params,
                          input if input is not None else ())
    if isinstance(out, (tuple, list)):
        return tuple(_as_tensor(o) for o in out)
    return (_as_tensor(out),)


def modjac(model, input=None, flatten=False, **kwargs):
    r"""Jacobian of a model's output with respect to its parameters: per
    output a matrix [output_i.numel(), total parameter size] (a list), or
    their row concatenation when ``flatten=True``.

    Ref: pypose_tpu/optim/functional.py:modjac (``vectorize`` and
    ``strategy`` keywords are taken and ignored).
    """
    names, leaves, ltypes = _leaves(model.parameter_dict())

    def func(*ls):
        out = _outputs(model, _rebuild(names, ls, ltypes), input)
        return out, out

    J, outs = torch.func.jacrev(func, argnums=tuple(range(len(leaves))),
                                has_aux=True)(*leaves)
    rows = [torch.cat([j.reshape(o.numel(), l.numel())
                       for j, l in zip(Ji, leaves)], dim=1)
            for Ji, o in zip(J, outs)]
    return torch.cat(rows, dim=0) if flatten else rows


def _modjac_transform(transform, model, input, argnums, has_aux):
    params = {n: v.detach() for n, v in model.parameter_dict().items()}

    def func(p, inp):
        return functional_call(model, p, inp)

    return transform(func, argnums=argnums, has_aux=has_aux)(params, input)


def modjacrev(model, input, argnums=0, has_aux=False):
    """``torch.func.jacrev`` of the model's output with respect to the
    parameter dict.  Ref: pypose_tpu/optim/functional.py:modjacrev."""
    return _modjac_transform(torch.func.jacrev, model, input, argnums,
                             has_aux)


def modjacfwd(model, input, argnums=0, has_aux=False):
    """``torch.func.jacfwd`` of the model's output with respect to the
    parameter dict.  Ref: pypose_tpu/optim/functional.py:modjacfwd."""
    return _modjac_transform(torch.func.jacfwd, model, input, argnums,
                             has_aux)
