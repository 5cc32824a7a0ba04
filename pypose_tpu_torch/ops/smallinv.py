r"""Closed-form batched small-matrix inverses.

Counterpart of ``pypose_tpu/ops/smallinv.py``: the adjugate 3x3
inverse and solve, the closed-form 3x3 Cholesky, the 6x6 inverse by
3x3-blockwise Schur complement, and ``blockinv`` dispatching between them
(``torch.linalg.inv`` otherwise); and the scalarized forms
(``inv3x3_scalar``, ``inv6x6_scalar``, ``blockinv_scalar``), which take
and return row-major lists of same-shaped component tensors.  Used for the
block-Jacobi preconditioners of the stencil CG and of the einsum CG
(``optim/sparse.py``), whose damped Hessian blocks are SPD and diagonally
dominant, and by the block cyclic reduction (``ops/block_tridiag.py``).
"""

import torch


def inv3x3(M):
    """Adjugate-based batched 3x3 inverse: (*, 3, 3) -> (*, 3, 3)."""
    comps = [M[..., i, j] for i in range(3) for j in range(3)]
    return torch.stack(inv3x3_scalar(comps), dim=-1).reshape(M.shape)


def solve3x3(M, b):
    """Batched 3x3 solve through the adjugate inverse: (*, 3, 3), (*, 3)
    -> (*, 3)."""
    return torch.einsum('...ij,...j->...i', inv3x3(M), b)


def inv6x6(M):
    """Batched 6x6 inverse via the 3x3-blockwise Schur complement (for
    SPD, diagonally dominant blocks)."""
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    C = M[..., 3:, :3]
    D = M[..., 3:, 3:]
    Ai = inv3x3(A)
    AiB = Ai @ B
    CAi = C @ Ai
    Si = inv3x3(D - C @ AiB)
    top = torch.cat([Ai + (AiB @ Si) @ CAi, -(AiB @ Si)], dim=-1)
    bot = torch.cat([-(Si @ CAi), Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def blockinv(M):
    """Dispatch: 3x3 / 6x6 closed forms, else ``torch.linalg.inv``."""
    n = M.shape[-1]
    if n == 3:
        return inv3x3(M)
    if n == 6:
        return inv6x6(M)
    return torch.linalg.inv(M)


def chol3x3(A):
    """Batched closed-form lower Cholesky factor of 3x3 SPD matrices:
    (*, 3, 3) -> (*, 3, 3)."""
    a11 = torch.sqrt(A[..., 0, 0])
    l21 = A[..., 1, 0] / a11
    l31 = A[..., 2, 0] / a11
    a22 = torch.sqrt(A[..., 1, 1] - l21 * l21)
    l32 = (A[..., 2, 1] - l31 * l21) / a22
    a33 = torch.sqrt(A[..., 2, 2] - l31 * l31 - l32 * l32)
    z = torch.zeros_like(a11)
    return torch.stack([torch.stack([a11, z, z], -1),
                        torch.stack([l21, a22, z], -1),
                        torch.stack([l31, l32, a33], -1)], -2)


# ---------------------------------------------------------------------------
# scalarized forms: row-major lists of d*d same-shaped component tensors in
# and out, every stage elementwise on the components
# ---------------------------------------------------------------------------

def inv3x3_scalar(c):
    """Adjugate 3x3 inverse on a row-major component list (len 9)."""
    a, b, c_, d, e, f, g, h, i = c
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c_ * h)
    E = a * i - c_ * g
    F = -(a * h - b * g)
    G = b * f - c_ * e
    H = -(a * f - c_ * d)
    I = a * e - b * d  # noqa: E741
    det = a * A + b * B + c_ * C
    det = torch.where(torch.abs(det) < 1e-36, 1e-36, det)
    inv = 1.0 / det
    return [A * inv, D * inv, G * inv,
            B * inv, E * inv, H * inv,
            C * inv, F * inv, I * inv]


def _mm3_scalar(x, y):
    """Row-major 3x3 component-list product."""
    return [sum(x[i * 3 + k] * y[k * 3 + j] for k in range(3))
            for i in range(3) for j in range(3)]


def inv6x6_scalar(c):
    """6x6 inverse by 3x3-blockwise Schur complement on a row-major
    component list (len 36): the scalarized :func:`inv6x6`."""
    def blk(ro, co):
        return [c[(ro + i) * 6 + (co + j)] for i in range(3)
                for j in range(3)]

    A, B, C, D = blk(0, 0), blk(0, 3), blk(3, 0), blk(3, 3)
    Ai = inv3x3_scalar(A)
    AiB = _mm3_scalar(Ai, B)
    CAi = _mm3_scalar(C, Ai)
    CAiB = _mm3_scalar(C, AiB)
    Si = inv3x3_scalar([D[k] - CAiB[k] for k in range(9)])
    AiBSi = _mm3_scalar(AiB, Si)
    TL = [Ai[k] + v for k, v in enumerate(_mm3_scalar(AiBSi, CAi))]
    BL = [-v for v in _mm3_scalar(Si, CAi)]
    out = [None] * 36
    for i in range(3):
        for j in range(3):
            out[i * 6 + j] = TL[i * 3 + j]
            out[i * 6 + j + 3] = -AiBSi[i * 3 + j]
            out[(i + 3) * 6 + j] = BL[i * 3 + j]
            out[(i + 3) * 6 + j + 3] = Si[i * 3 + j]
    return out


def blockinv_scalar(c):
    """Dispatch on the component list's length: 9 -> 3x3, 36 -> 6x6."""
    if len(c) == 9:
        return inv3x3_scalar(c)
    if len(c) == 36:
        return inv6x6_scalar(c)
    raise NotImplementedError(f'blockinv_scalar: d*d={len(c)}')
