r"""Correctors that scale residuals and Jacobians for robust least
squares.

Counterpart of ``pypose_tpu/optim/corrector.py``: the kernel's
derivatives come from ``torch.func.grad``, so a corrector composes with
``torch.func.vmap`` as the batched optimizer needs.
"""

import torch


class Trivial:
    """Identity placeholder: returns its arguments.  Ref:
    pypose_tpu/optim/corrector.py:Trivial."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, *args, **kwargs):
        out = tuple(args) + tuple(kwargs.values())
        return out[0] if len(out) == 1 else out


def _kernel_sum(kernel):
    return lambda v: torch.sum(kernel(v))


class FastTriggs:
    r"""First-order Triggs correction: R and J scaled by
    :math:`\sqrt{\rho'(\|r\|^2)}`.

    Ref: pypose_tpu/optim/corrector.py:FastTriggs.
    """

    def __init__(self, kernel):
        self.kernel = kernel

    def __call__(self, R, J):
        x = torch.sum(R * R, dim=-1, keepdim=True)
        g1 = torch.func.grad(_kernel_sum(self.kernel))(x)
        s = torch.sqrt(torch.clamp(g1, min=0.0))
        sj = s.expand(R.shape).reshape(-1, 1)
        return s * R, sj * J


class Triggs:
    r"""Second-order Triggs correction (Eq. 11, Triggs et al. 1999), with
    the JAX package's residual correction ``sqrt(g1) / (1 - alpha) * R``
    on the corrected rows.

    Ref: pypose_tpu/optim/corrector.py:Triggs.
    """

    def __init__(self, kernel):
        self.kernel = kernel

    def compute_grads(self, R):
        x = torch.sum(R * R, dim=-1, keepdim=True)
        f = _kernel_sum(self.kernel)
        g1 = torch.func.grad(f)(x)
        g2 = torch.func.grad(
            lambda v: torch.sum(torch.func.grad(f)(v)))(x)
        return x, g1, g2

    def __call__(self, R, J):
        x, g1, g2 = self.compute_grads(R)
        se = torch.sqrt(torch.clamp(g1, min=0.0))
        Jv = J.reshape(R.shape + (J.shape[-1],))
        sj = se[..., None]
        sR = se * R
        sJ = sj * Jv
        M = ~((x == 0) | (g2 <= 0))
        g1s = torch.where(g1 == 0, 1.0, g1)
        alpha = 1.0 - torch.sqrt(torch.clamp(1.0 + 2.0 * x * g2 / g1s,
                                             min=0.0))
        alpha = torch.where(M, alpha, 0.0)
        one_minus = torch.where(alpha == 1.0, 1.0, 1.0 - alpha)
        sR = torch.where(M, se * R / one_minus, sR)
        xs = torch.where(x == 0, 1.0, x)
        Q = torch.einsum('...d,...k,...kl->...dl', R, R, sJ)
        sJ = torch.where(M[..., None], sJ - (alpha / xs)[..., None] * Q, sJ)
        return sR, sJ.reshape(J.shape)
