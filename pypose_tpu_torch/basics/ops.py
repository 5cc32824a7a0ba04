r"""Sign with +1 at zero, and O(log N) cumulative scans.

Counterpart of ``pypose_tpu/basics/ops.py``.  The JAX package scans with
``jax.lax.associative_scan``; :func:`associative_scan` here is its torch
counterpart with the same odd/even recursion, so a user op is combined
in the same order (bit for bit with JAX's own elementwise ops) and the
scan keeps O(log N) depth.  It takes any torch pytree of tensors
(a tensor, a tuple of them, a LieTensor), so LieTensor slices reach the
user's group op directly.
"""

import torch
import torch.utils._pytree as pytree


def _slice(x, dim, start, stop=None, step=1):
    return x[(slice(None),) * dim + (slice(start, stop, step),)]


def _interleave(even, odd, dim):
    """even[0], odd[0], even[1], ... along ``dim`` (len(even) is len(odd)
    or one more)."""
    n = odd.shape[dim]
    pairs = torch.stack([_slice(even, dim, 0, n), odd], dim + 1)
    out = pairs.flatten(dim, dim + 1)
    if even.shape[dim] > n:
        out = torch.cat([out, _slice(even, dim, n)], dim)
    return out


def associative_scan(fn, elems, dim=0, reverse=False):
    r"""Inclusive scan of the associative ``fn`` over ``dim`` of every
    leaf of ``elems``: :math:`y_i = x_0 \circ x_1 \circ \dots \circ x_i`
    (with ``reverse=True``, :math:`y_i = x_{N-1} \circ \dots \circ x_i`).

    The recursion of ``jax.lax.associative_scan``: combine adjacent
    pairs, scan the half-length result (the odd outputs), combine each
    odd output with the next even input (the even outputs), interleave;
    ``reverse`` flips the leaves before and after.  ``fn`` takes and
    returns the structure of ``elems``.

    Example:
        >>> import torch
        >>> from pypose_tpu_torch.basics.ops import associative_scan
        >>> associative_scan(torch.add, torch.arange(4.))
        tensor([0., 1., 3., 6.])
        >>> associative_scan(torch.add, torch.arange(4.), reverse=True)
        tensor([6., 6., 5., 3.])
    """
    leaves, spec = pytree.tree_flatten(elems)
    dim = dim % leaves[0].dim()
    if reverse:
        leaves = [torch.flip(x, (dim,)) for x in leaves]

    def combine(a, b):
        out = fn(pytree.tree_unflatten(a, spec),
                 pytree.tree_unflatten(b, spec))
        return pytree.tree_flatten(out)[0]

    def scan(xs):
        n = xs[0].shape[dim]
        if n < 2:
            return xs
        odd = scan(combine([_slice(x, dim, 0, -1, 2) for x in xs],
                           [_slice(x, dim, 1, None, 2) for x in xs]))
        if n % 2 == 0:
            even = combine([_slice(o, dim, 0, -1) for o in odd],
                           [_slice(x, dim, 2, None, 2) for x in xs])
        else:
            even = combine(odd, [_slice(x, dim, 2, None, 2) for x in xs])
        even = [torch.cat([_slice(x, dim, 0, 1), e], dim)
                for x, e in zip(xs, even)]
        return [_interleave(e, o, dim) for e, o in zip(even, odd)]

    out = scan(leaves)
    if reverse:
        out = [torch.flip(x, (dim,)) for x in out]
    return pytree.tree_unflatten(out, spec)


def pm(input):
    """Sign function returning +1 at 0 (``torch.sign`` returns 0 there).

    Ref: pypose_tpu/basics/ops.py:15.

    Example:
        >>> import torch, pypose_tpu_torch as pp
        >>> pp.pm(torch.tensor([-2., 0., 3.]))
        tensor([-1.,  1.,  1.])
    """
    from ..lietensor.lietensor import LieTensor
    x = input.tensor() if isinstance(input, LieTensor) \
        else torch.as_tensor(input)
    return torch.where(x >= 0, torch.ones_like(x), -torch.ones_like(x))


def _check_dim(input, dim):
    ndim = len(input.lshape) if hasattr(input, 'lshape') else input.dim() - 1
    if dim < 0:
        dim += ndim + 1
    assert 0 <= dim < ndim + 1 and dim != ndim, \
        "Invalid dim: cannot scan over the storage dimension"
    return dim


def cumops(input, dim, ops):
    r"""Cumulative user-defined associative op along ``dim``:
    :math:`y_i = x_1 \circ x_2 \circ \dots \circ x_i`, in O(log N) depth
    by :func:`associative_scan`; ``ops`` must be associative for the scan
    to be exact.

    Ref: pypose_tpu/basics/ops.py:39.

    Example:
        >>> import torch, pypose_tpu_torch as pp
        >>> x = pp.so3(torch.eye(3) * 0.1).Exp()    # three small rotations
        >>> y = pp.cumops(x, 0, lambda a, b: a @ b)
        >>> bool(torch.allclose(y[2].tensor(), (x[0] @ x[1] @ x[2]).tensor()))
        True
    """
    return associative_scan(ops, input, dim=_check_dim(input, dim))


def cummul(input, dim, left=True):
    r"""Cumulative group multiplication along ``dim``.  Left (default):
    :math:`y_i = x_i * x_{i-1} * \dots * x_1`; right:
    :math:`y_i = x_1 * \dots * x_i`.

    Ref: pypose_tpu/basics/ops.py:62.
    """
    from ..lietensor.lietensor import LieTensor, SO3_type
    if isinstance(input, LieTensor) and input.ltype is SO3_type:
        return _cum_quat(input, _check_dim(input, dim), left)
    if left:
        return cumops(input, dim, lambda a, b: b * a)
    return cumops(input, dim, lambda a, b: a * b)


def _cum_quat(input, dim, left):
    """SO3 cumulative product on the four quaternion component tensors,
    combined by ``lietensor/scalarized.py:_qmul`` and never renormalised,
    as ``pypose_tpu/basics/ops.py:86-101`` does."""
    from ..lietensor.lietensor import LieTensor
    from ..lietensor.scalarized import _qmul
    q = input.tensor()
    comps = tuple(q[..., k] for k in range(4))
    fn = (lambda a, b: _qmul(b, a)) if left else (lambda a, b: _qmul(a, b))
    out = associative_scan(fn, comps, dim=dim)
    return LieTensor(torch.stack(out, dim=-1), ltype=input.ltype)


def cumprod(input, dim, left=True):
    r"""Cumulative group composition (``@``) along ``dim``.  Left
    (default): :math:`y_i = x_i \cdot x_{i-1} \cdots x_1`; right reverses
    the order.

    Ref: pypose_tpu/basics/ops.py:104.

    Example:
        >>> import torch, pypose_tpu_torch as pp
        >>> x = pp.randn_SE3(4, generator=torch.Generator().manual_seed(1))
        >>> y = pp.cumprod(x, dim=0, left=False)
        >>> bool(torch.allclose(y[3].tensor(),
        ...                     (x[0] @ x[1] @ x[2] @ x[3]).tensor(),
        ...                     atol=1e-6))
        True
    """
    from ..lietensor.lietensor import LieTensor, SO3_type
    if isinstance(input, LieTensor) and input.ltype is SO3_type:
        return _cum_quat(input, _check_dim(input, dim), left)
    if left:
        return cumops(input, dim, lambda a, b: b @ a)
    return cumops(input, dim, lambda a, b: a @ b)


# the JAX package's in-place names alias the pure functions
# (pypose_tpu/basics/ops.py:133-135)
cumops_ = cumops
cummul_ = cummul
cumprod_ = cumprod
