r"""A filter over a whole trajectory.  Counterpart of
``pypose_tpu/module/filtering.py:14-50``: the JAX package's ``lax.scan``
is an eager loop over the steps here, which reads nothing back to the
host."""

import torch

from .pf import PF


def rollout(filt, x0, P0, ys, us, Q=None, R=None, generator=None):
    r"""Run ``filt`` over T steps of observations and inputs.

    Args:
        filt: an EKF, UKF or PF.
        x0: initial estimate (n,).
        P0: initial covariance (n, n).
        ys: observations (T, m).
        us: inputs (T, k).
        Q, R: optional covariances for every step.
        generator: the PF's ``torch.Generator`` (one for all steps).
    Returns:
        (xs, Ps): estimates (T, n) and covariances (T, n, n).

    Ref: pypose_tpu/module/filtering.py:14-50.
    """
    kwargs = {} if Q is None else {'Q': Q}
    if R is not None:
        kwargs['R'] = R
    if isinstance(filt, PF):
        kwargs['generator'] = generator
    x, P = x0, P0
    xs, Ps = [], []
    for t in range(ys.shape[0]):
        x, P = filt(x, ys[t], us[t], P, **kwargs)
        xs.append(x)
        Ps.append(P)
    return torch.stack(xs), torch.stack(Ps)
