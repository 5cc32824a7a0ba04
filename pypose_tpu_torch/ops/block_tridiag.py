r"""Block-tridiagonal solves by block cyclic reduction (BCR).

Counterpart of ``pypose_tpu/ops/block_tridiag.py``.  The odometry chain of
a pose graph makes the chain part of J^T W J block tridiagonal, and its
condition number grows ~O(N^2) with the chain's length, which stalls
Jacobi-preconditioned CG; solving that part exactly, as the
preconditioner, removes the chain's long-range stiffness.

Cyclic reduction eliminates the odd-indexed block unknowns level by
level: log2(N) levels of batched t x t products and inverses over strided
slices.  :func:`bcr_factor` (matrix-dependent) runs once per LM damping;
:func:`bcr_solve` (right-hand-side dependent) runs per CG iteration, about
15 small torch operations a level.

The factor's level products (:func:`_mm`) sum each entry as a forward
FMA chain, as XLA's CPU backend sums the JAX package's batched matmuls;
torch's CPU matmul rounds every product apart, and on a long odometry
chain that ~15% larger error per product compounds over the levels.

System convention: T x = b with

    T = blocktridiag(L, D, U):  row i couples (i-1, i, i+1) through
    L[i] (sub), D[i] (diagonal), U[i] (super); L[0] and U[N-1] are
    ignored.
"""

import math

import torch

from .smallinv import blockinv


def _mv(M, v):
    return torch.einsum('...ij,...j->...i', M, v)


def _mm(a, b):
    """``a @ b`` over batched t x t blocks with each entry summed as a
    forward FMA chain, ``s = fma(a_ik, b_kj, s)`` from k = 0.  In float32
    each FMA is taken in float64 (the product is exact there) and rounded
    back, the same bits on every device; float64 blocks use
    ``torch.matmul``."""
    if a.dtype != torch.float32:
        return a @ b
    a64, b64 = a.double(), b.double()
    s = (a64[..., :, :1] * b64[..., :1, :]).float()
    for k in range(1, a.shape[-1]):
        s = (s.double() + a64[..., :, k:k + 1] * b64[..., k:k + 1, :]).float()
    return s


def _pow2(N):
    return 1 << max(1, math.ceil(math.log2(max(N, 2))))


def _pad_pow2(D, L, U):
    """Pad to a power of two with identity diagonal blocks and zero
    couplings."""
    N = D.shape[0]
    Np = _pow2(N)
    if Np == N:
        return D, L, U, N
    t = D.shape[-1]
    eye = torch.eye(t, dtype=D.dtype, device=D.device).expand(Np - N, t, t)
    zero = D.new_zeros((Np - N, t, t))
    return (torch.cat([D, eye]), torch.cat([L, zero]), torch.cat([U, zero]),
            N)


def _shift_up(x):
    """x'[i] = x[i-1], zeros at i = 0 (along dim 0)."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]])


def _shift_down(x):
    """x'[i] = x[i+1], zeros at the end."""
    return torch.cat([x[1:], torch.zeros_like(x[:1])])


def bcr_factor(D, L, U):
    r"""Factor a block-tridiagonal SPD-like system for repeated solves.

    Args: D [N, t, t], L [N, t, t] (L[0] unused), U [N, t, t] (U[N-1]
    unused).  Returns the factorization :func:`bcr_solve` takes: the
    levels' blocks, the root's inverse and N.
    """
    D, L, U, N = _pad_pow2(D, L, U)
    # decouple the boundaries and the padding
    L = L.clone()
    U = U.clone()
    L[0] = 0.0
    U[N - 1] = 0.0
    levels = []
    while D.shape[0] > 1:
        Do, Lo, Uo = D[1::2], L[1::2], U[1::2]          # odd rows
        De, Le, Ue = D[0::2], L[0::2], U[0::2]          # even rows
        invDo = blockinv(Do)
        # even row i couples its odd neighbours i - 1 (through Le; none
        # for i = 0) and i + 1 (through Ue)
        alpha = _mm(Le, _shift_up(invDo))               # L_i D_{i-1}^-1
        beta = _mm(Ue, invDo)                           # U_i D_{i+1}^-1
        alpha[0] = 0.0
        D_new = De - _mm(alpha, _shift_up(Uo)) - _mm(beta, Lo)
        L_new = -_mm(alpha, _shift_up(Lo))
        U_new = -_mm(beta, Uo)
        levels.append(dict(invDo=invDo, alpha=alpha, beta=beta, Lo=Lo,
                           Uo=Uo))
        D, L, U = D_new, L_new, U_new
    return dict(levels=levels, root_inv=blockinv(D), n=N)


def bcr_solve(fac, b):
    """Solve T x = b with a :func:`bcr_factor` result; b: [N, t]."""
    N = fac['n']
    t = b.shape[-1]
    Np = _pow2(N)
    if Np != N:
        b = torch.cat([b, b.new_zeros((Np - N, t))])
    # forward reduction
    bs = [b]
    for lv in fac['levels']:
        bo = b[1::2]
        b = b[0::2] - _mv(lv['alpha'], _shift_up(bo)) - _mv(lv['beta'], bo)
        bs.append(b)
    x = _mv(fac['root_inv'], b)
    # back substitution: x holds the even rows' solution of each level
    for lv, b_prev in zip(reversed(fac['levels']), reversed(bs[:-1])):
        # odd row i's neighbours: even rows i - 1 (x) and i + 1
        xo = _mv(lv['invDo'], b_prev[1::2] - _mv(lv['Lo'], x)
                 - _mv(lv['Uo'], _shift_down(x)))
        x = torch.stack([x, xo], dim=1).reshape(-1, t)
    return x[:N]


def blocktridiag_matvec(D, L, U, x):
    """Reference matvec for tests: row i = L x_{i-1} + D x_i + U x_{i+1}."""
    return _mv(D, x) + _mv(L, _shift_up(x)) + _mv(U, _shift_down(x))
