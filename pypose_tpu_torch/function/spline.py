r"""Splines: the cubic Hermite spline on R^n (``chspline``) and the
cumulative cubic B-spline on SE3 (``bspline``).

Counterpart of ``pypose_tpu/function/spline.py:14-114``, in the same
operations and order.  The sample offsets ``arange(0, 1, interval)`` are
numpy's, as ``jnp.arange`` with a step takes them, so both packages draw
the same samples in float32 and float64; ``searchsorted`` is left-sided in
both.  The B-spline's SE3 products are torch ops (the JAX package's are
XLA ops; neither reaches a Pallas kernel).
"""

import numpy as np
import torch

from ..lietensor.lietensor import LieTensor
from .checking import is_SE3

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _offsets(interval, dtype, device):
    """``np.arange(0, 1, interval)`` in ``dtype`` on ``device``."""
    return torch.as_tensor(np.arange(0, 1, interval,
                                     dtype=_NP_DTYPES[dtype]), device=device)


def chspline(points, interval=0.1):
    r"""Cubic Hermite spline through waypoints ``(*, N, C)`` sampled at
    ``interval`` (a fraction of a segment); the slopes are central
    differences.  The curve passes through every waypoint.

    Example:
        >>> import torch, pypose_tpu_torch as pp
        >>> wp = torch.tensor([[0.], [1.], [0.]])
        >>> y = pp.chspline(wp, interval=0.5)
        >>> tuple(y.shape)                        # 2 samples/segment + end
        (5, 1)
        >>> bool(torch.allclose(y[::2, 0], wp[:, 0]))   # hits the waypoints
        True
    """
    points = torch.as_tensor(points)
    assert points.ndim >= 2, 'Dimension of points should be [..., N, C]'
    assert interval < 1.0, 'The interval should be smaller than 1.'
    N = points.shape[-2]
    dt, dev = points.dtype, points.device
    intervals = _offsets(interval, dt, dev)
    x = torch.arange(N, dtype=dt, device=dev)
    timeline = (x[:, None] + intervals).reshape(-1)
    k = intervals.shape[0] - 1
    if k > 0:
        timeline = timeline[:-k]
    idxs = torch.searchsorted(x[1:], timeline)
    m = points[..., 1:, :] - points[..., :-1, :]
    m = m / (x[1:] - x[:-1])[..., None]
    m = torch.cat([m[..., :1, :], (m[..., 1:, :] + m[..., :-1, :]) / 2,
                   m[..., -1:, :]], dim=-2)
    dx = x[idxs + 1] - x[idxs]
    t = (timeline - x[idxs]) / dx
    alpha = torch.arange(4, dtype=dt, device=dev)
    tt = t[None, :] ** alpha[:, None]
    A = torch.tensor([[1, 0, -3, 2], [0, 1, -2, 1],
                      [0, 0, 3, -2], [0, 0, -1, 1]], dtype=dt, device=dev)
    hh = (A @ tt).transpose(-1, -2)
    out = hh[..., :1] * points[..., idxs, :]
    out = out + hh[..., 1:2] * m[..., idxs, :] * dx[..., None]
    out = out + hh[..., 2:3] * points[..., idxs + 1, :]
    out = out + hh[..., 3:4] * m[..., idxs + 1, :] * dx[..., None]
    return out


def bspline(data, interval=0.1, extrapolate=False):
    r"""Cumulative cubic B-spline over SE3 control poses ``(*, N)``:

    .. math:: T(t) = T_i \prod_{j=1}^{3}
              \mathrm{Exp}\big(\tilde B_j(t)\,
              \mathrm{Log}(T_{i+j-1}^{-1} T_{i+j})\big)

    with the cumulative basis :math:`\tilde B`.  The curve is smooth but
    does not pass through the control poses; ``extrapolate=True`` pads
    each end with two copies of its pose so the output spans all inputs.
    ``(N - 3) / interval + 1`` poses (with ``N`` after padding).

    Example:
        >>> import torch, pypose_tpu_torch as pp
        >>> ctrl = pp.randn_SE3(6, sigma=0.1,
        ...                     generator=torch.Generator().manual_seed(0))
        >>> traj = pp.bspline(ctrl, interval=0.25)
        >>> traj.ltype is pp.SE3_type, tuple(traj.lshape)   # (N-3)*4 + 1
        (True, (13,))
    """
    assert is_SE3(data), 'The input poses are not SE3Type.'
    assert len(data.lshape) >= 1, 'Dimension of data should be [..., N, C].'
    assert interval < 1.0, 'The interval should be smaller than 1.'
    batch = tuple(data.lshape[:-1])
    if extrapolate:
        first = data[..., :1, :].expand(batch + (2, 7))
        last = data[..., -1:, :].expand(batch + (2, 7))
        data = _cat_lie([first, data, last])
    else:
        assert data.lshape[-1] >= 4, 'Number of poses is less than 4.'
    Bth, N = tuple(data.lshape[:-1]), data.lshape[-1]
    dt, dev = data.dtype, data.device
    timeline = _offsets(interval, dt, dev)
    tt = timeline ** torch.arange(4, dtype=dt, device=dev)[:, None]  # [4, T]
    B = torch.tensor([[5, 3, -3, 1], [1, 3, 3, -2], [0, 0, 0, 1]],
                     dtype=dt, device=dev) / 6                      # [3, 4]
    dP = data[..., 0:N - 3, :].unsqueeze(-2)                  # [.., N-3, 1]
    w = (B @ tt)[..., None]                                   # [3, T, 1]
    index = (torch.arange(0, N - 3, device=dev)[:, None]
             + torch.arange(0, 4, device=dev)).reshape(-1)
    P = data[..., index, :].lview(*(Bth + (N - 3, 4, 1)))
    P = (P[..., 0:3, :, :].Inv() * P[..., 1:4, :, :]).Log()   # se3 [.., N-3, 3, 1]
    A = (P * w).Exp()                                         # [.., N-3, 3, T]
    Aend = (P[..., -1, :] * B.sum(dim=1)[:, None]).Exp()      # [.., N-3, 3]
    Aend = Aend[..., 0:1, :] * Aend[..., 1:2, :] * Aend[..., 2:3, :]
    A = A[..., 0, :, :] * A[..., 1, :, :] * A[..., 2, :, :]   # [.., N-3, T]
    ps = dP * A                                               # [.., N-3, T]
    pend = dP[..., -1, :, :] * Aend[..., -1, :, :]
    return _cat_lie([ps.lview(*(Bth + (-1,))), pend])


def _cat_lie(xs):
    return LieTensor(torch.cat([x.tensor() for x in xs], dim=-2),
                     ltype=xs[0].ltype)
