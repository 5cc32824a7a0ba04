r"""Closed-form batched small-matrix inverses.

Counterpart of ``pypose_tpu/ops/smallinv.py:18-77``: the adjugate 3x3
inverse, the 6x6 inverse by 3x3-blockwise Schur complement, and
``blockinv`` dispatching between them (``torch.linalg.inv`` otherwise).
Used for the block-Jacobi preconditioner of the stencil CG, whose damped
6x6 Hessian blocks are SPD and diagonally dominant.
"""

import torch


def inv3x3(M):
    """Adjugate-based batched 3x3 inverse: (*, 3, 3) -> (*, 3, 3)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d  # noqa: E741
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-36, 1e-36, det)
    adj = torch.stack([
        torch.stack([A, D, G], dim=-1),
        torch.stack([B, E, H], dim=-1),
        torch.stack([C, F, I], dim=-1),
    ], dim=-2)
    return adj * (1.0 / det)[..., None, None]


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
