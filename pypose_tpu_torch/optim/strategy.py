r"""LM damping strategies as state-transition functions.

Counterpart of ``pypose_tpu/optim/strategy.py:99-140``: ``TrustRegion``
with its state as a dict of 0-d tensors, so the LM loop can keep it on
the card.  ``Constant`` and ``Adaptive`` wait for the dense-optimizer
slice.  SparseLM applies the update from its own gain ratio
(``SparseLM._strategy_update``).
"""

import torch


class TrustRegion:
    r"""Ceres-style trust region: damping is the reciprocal radius, the
    radius grows by ``up`` on high-quality steps and shrinks by a ``down``
    factor that itself decays (``factor``) on consecutive poor steps."""

    def __init__(self, radius=1e6, high=0.5, low=1e-3, up=2., down=0.5,
                 factor=0.5, min=1e-6, max=1e16):
        if not (radius > 0 and high > 0 and low > 0 and 0 < down < 1
                and up > 1 and 0 < factor < 1):
            raise ValueError('TrustRegion needs radius, high, low > 0, '
                             '0 < down < 1, up > 1 and 0 < factor < 1')
        self.radius, self.high, self.low = radius, high, low
        self.up, self.down0, self.factor = up, down, factor
        self.min, self.max = min, max

    def init(self, dtype=torch.float32, device=None):
        return {'damping': torch.tensor(1.0 / self.radius, dtype=dtype,
                                        device=device),
                'down': torch.tensor(self.down0, dtype=dtype, device=device)}
