r"""Robust M-estimator kernels on x = ||r||^2.

Counterpart of ``pypose_tpu/optim/kernel.py``.  Elementwise callables; a
branch is a ``torch.where`` (never a mask index), so ``torch.autograd``
and ``torch.func`` differentiate through it, as ``SparseLM``'s FastTriggs
scaling does.

Example:
    >>> import torch
    >>> from pypose_tpu_torch.optim.kernel import Huber
    >>> Huber(delta=2.0)(torch.tensor([1.0, 9.0]))   # 1 < 4: quadratic
    tensor([1., 8.])
"""

import math

import torch


def _positive(name, value):
    if not value > 0:
        raise ValueError(f'{name} has to be positive: {value}')


class Huber:
    r"""Huber kernel: :math:`x` where :math:`\sqrt{x} < \delta`, else
    :math:`2\delta\sqrt{x} - \delta^2`."""

    def __init__(self, delta=1.0):
        _positive('delta', delta)
        self.delta = delta
        self.delta2 = delta ** 2

    def __call__(self, input):
        root = torch.sqrt(torch.clamp(input, min=1e-36))
        return torch.where(root < self.delta, input,
                           2 * self.delta * root - self.delta2)


class PseudoHuber:
    r""":math:`2\delta^2(\sqrt{x/\delta^2 + 1} - 1)`, smooth everywhere."""

    def __init__(self, delta=1.0):
        _positive('delta', delta)
        self.delta2 = delta ** 2

    def __call__(self, input):
        return 2 * self.delta2 * (torch.sqrt(input / self.delta2 + 1) - 1)


class Cauchy:
    r""":math:`\delta^2 \log(x/\delta^2 + 1)`."""

    def __init__(self, delta=1.0):
        _positive('delta', delta)
        self.delta2 = delta ** 2

    def __call__(self, input):
        return self.delta2 * torch.log(input / self.delta2 + 1)


class SoftLOne:
    r""":math:`2(\delta\sqrt{1/\delta^2 + x} - 1)`."""

    def __init__(self, delta=1.0):
        _positive('delta', delta)
        self.delta1 = delta
        self.delta2 = delta ** 2

    def __call__(self, input):
        return 2 * (self.delta1 * torch.sqrt(1 / self.delta2 + input) - 1)


class Arctan:
    r""":math:`\delta^2 \arctan(x/\delta^2)`."""

    def __init__(self, delta=1.0):
        self.delta2 = delta ** 2

    def __call__(self, input):
        return self.delta2 * torch.atan(input / self.delta2)


class Tolerant:
    r""":math:`b \log(1 + e^{(x - a)/b}) - b \log(1 + e^{-a/b})`, with
    a > 0 and b < 0."""

    def __init__(self, a=1.0, b=-1.0):
        _positive('a', a)
        if not b < 0:
            raise ValueError(f'b has to be negative: {b}')
        self.a, self.b = a, b

    def __call__(self, input):
        result = self.b * torch.log(1 + torch.exp((input - self.a) / self.b))
        return result - self.b * math.log(1 + math.exp(-self.a / self.b))


class Scale:
    r""":math:`\delta x` with :math:`0 < \delta \le 1`."""

    def __init__(self, delta=1.0):
        if not 0 < delta <= 1:
            raise ValueError(f'delta has to be between 0 and 1: {delta}')
        self.delta = delta

    def __call__(self, input):
        return self.delta * input
