r"""Linear solvers for the least-squares optimizers.

Counterpart of ``pypose_tpu/optim/solver.py``: the dense solvers
(:class:`PINV`, :class:`LSTSQ`, :class:`Cholesky`) and the conjugate
gradients (:class:`CG`, :class:`PCG`), which take a dense matrix or a
matvec callable.  :func:`cg` is the CG over dicts of tensors that
``SparseLM`` runs on its normal equations, with the recursion and the
stopping rule of ``jax.scipy.sparse.linalg.cg``
(``jax/_src/scipy/sparse/linalg.py:_cg_solve``).
"""

import torch

# Host reads made by cg's stop test in this process (one an iteration).
CG_HOST_READS = 0


class PINV:
    """Moore-Penrose pseudo-inverse solve."""

    def __init__(self, atol=None, rtol=None, hermitian=False):
        self.atol, self.rtol, self.hermitian = atol, rtol, hermitian

    def __call__(self, A, b):
        return torch.linalg.pinv(A, rtol=self.rtol,
                                 hermitian=self.hermitian) @ b


class LSTSQ:
    """Least-squares solve, batched over leading dims; ``b`` is batch +
    (M,) or batch + (M, K)."""

    def __init__(self, rcond=None, driver=None):
        self.rcond, self.driver = rcond, driver

    def __call__(self, A, b):
        vec = b.ndim == A.ndim - 1
        bb = b[..., None] if vec else b
        batch = torch.broadcast_shapes(A.shape[:-2], bb.shape[:-2])
        out = torch.linalg.lstsq(A.expand(batch + A.shape[-2:]),
                                 bb.expand(batch + bb.shape[-2:]),
                                 rcond=self.rcond, driver=self.driver)[0]
        return out[..., 0] if vec else out


class Cholesky:
    """Cholesky solve for positive-definite systems; a matrix that is not
    positive definite gives NaN (no exception), so the LM reject loop can
    see the failure."""

    def __init__(self, upper=False):
        self.upper = upper

    def __call__(self, A, b):
        L, info = torch.linalg.cholesky_ex(A)
        vec = b.ndim == A.ndim - 1
        bb = b[..., None] if vec else b
        x = torch.cholesky_solve(bb, L)
        bad = (info != 0).reshape(info.shape + (1, 1))
        x = torch.where(bad, torch.nan, x)
        return x[..., 0] if vec else x


def _dot(x, y):
    """sum over the dict's tensors (in key order) of <x, y>."""
    return sum(torch.dot(x[n].reshape(-1), y[n].reshape(-1))
               for n in sorted(x))


def cg(A, b, x0=None, *, tol=1e-5, atol=0.0, maxiter=None, M=None):
    r"""Preconditioned conjugate gradient on dicts of tensors: solves
    ``A x = b`` for a symmetric positive-definite matvec ``A(x)`` (dict to
    dict) and an optional preconditioner ``M(r)``.  Returns ``(x, k)``,
    the iterate and the iterations run.

    The recursion and stopping rule of ``jax.scipy.sparse.linalg.cg``:
    atol^2 = max(tol^2 |b|^2, atol^2); iterate while |r|^2 > atol^2 and
    k < maxiter (|r|^2 is gamma = <r, z> without M, <r, r> with it);
    alpha = gamma / <p, A p>, beta = gamma' / gamma.  ``maxiter`` defaults
    to 10 times the unknowns, as scipy's does.

    The stop test reads one host scalar an iteration (counted in
    :data:`CG_HOST_READS`), which on CUDA waits for the device each time.
    """
    global CG_HOST_READS
    if x0 is None:
        x0 = {n: torch.zeros_like(v) for n, v in b.items()}
    if maxiter is None:
        maxiter = 10 * sum(v.numel() for v in b.values())
    precond = (lambda r: r) if M is None else M
    bs = _dot(b, b)
    atol2 = torch.clamp(tol * tol * bs, min=atol * atol)
    Ax0 = A(x0)
    r = {n: b[n] - Ax0[n] for n in b}
    z = precond(r)
    p = z
    gamma = _dot(r, z)
    x = x0
    k = 0
    while k < maxiter:
        rs = gamma if M is None else _dot(r, r)
        CG_HOST_READS += 1
        if not bool(rs > atol2):
            break
        Ap = A(p)
        alpha = gamma / _dot(p, Ap)
        x = {n: x[n] + alpha * p[n] for n in x}
        r = {n: r[n] - alpha * Ap[n] for n in r}
        z = precond(r)
        gamma_new = _dot(r, z)
        beta = gamma_new / gamma
        p = {n: z[n] + beta * p[n] for n in p}
        gamma = gamma_new
        k += 1
    return x, k


class CG:
    """Conjugate gradient (scipy's rules, :func:`cg`) on a dense matrix or
    a matvec callable ``A``, with an optional preconditioner ``M`` (matrix
    or callable); ``b`` is [n] or [n, 1]."""

    def __init__(self, maxiter=None, tol=1e-5):
        self.maxiter, self.tol = maxiter, tol

    def __call__(self, A, b, x=None, M=None):
        matvec = A if callable(A) else (lambda v: A @ v)
        squeeze = b.ndim == 2 and b.shape[-1] == 1
        if squeeze:
            b = b[:, 0]
        if x is not None and x.ndim == 2:
            x = x[:, 0]
        n = b.shape[-1] if b.ndim == 1 else b.shape[-2]
        maxiter = self.maxiter if self.maxiter is not None else 10 * n
        precond = None
        if M is not None:
            Mf = M if callable(M) else (lambda v: M @ v)
            precond = lambda r: {'x': Mf(r['x'])}  # noqa: E731
        out, _ = cg(lambda v: {'x': matvec(v['x'])}, {'x': b},
                    None if x is None else {'x': x}, tol=self.tol,
                    maxiter=maxiter, M=precond)
        out = out['x']
        return out[:, None] if squeeze else out


class PCG(CG):
    """CG with the Jacobi (diagonal) preconditioner by default for a dense
    ``A``."""

    def __call__(self, A, b, x=None, M=None):
        if M is None and not callable(A):
            d = torch.diagonal(A)
            dinv = torch.where(d > 0, 1.0 / torch.where(d == 0, 1.0, d), 1.0)

            def M(v):
                return dinv[:, None] * v if v.ndim == 2 else dinv * v
        return super().__call__(A, b, x=x, M=M)
