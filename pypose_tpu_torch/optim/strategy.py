r"""LM damping strategies as state-transition functions.

Counterpart of ``pypose_tpu/optim/strategy.py``: ``Constant``,
``Adaptive`` and ``TrustRegion``, each with its state as a dict of 0-d
tensors, so the LM loop can keep it on the card.  ``BundleAdjustment``
takes all three and ``SparseLM`` ``TrustRegion`` alone; both apply
``step(state, q)`` to a gain ratio q of their own, which never forms J.
``update`` takes the dense (J, D, R) of :func:`_quality`, as the JAX
package's does.
"""

import torch


def _quality(last, loss, J, D, R):
    """Gain ratio: actual over predicted reduction, with the JAX package's
    guard (``pypose_tpu/optim/strategy.py:12-33``): a step whose predicted
    reduction ``-(JD)^T (2 R + JD)`` is not positive (the local model says
    it does not descend, e.g. an unconverged inner CG) scores -1, a hard
    reject, where the reference divides blindly."""
    JD = J @ D
    pred = -(JD.T @ (2.0 * R + JD)).squeeze()
    q = (last - loss) / torch.where(pred == 0, 1e-31, pred)
    return torch.where(pred > 0, q, -1.0)


class Constant:
    """Constant LM damping (classic Levenberg)."""

    def __init__(self, damping=1e-6):
        if not damping > 0:
            raise ValueError(f'damping has to be positive: {damping}')
        self.damping = damping

    def init(self, dtype=torch.float32, device=None):
        return {'damping': torch.tensor(self.damping, dtype=dtype,
                                        device=device)}

    def update(self, state, last, loss, J, D, R):
        return state

    def step(self, state, q):
        """The update from a gain ratio: none."""
        return state


class Adaptive:
    r"""Gain-ratio damping: times ``down`` when the step quality (actual
    over predicted reduction) exceeds ``high``, times ``up`` when it is
    below ``low``, clipped to [min, max]."""

    def __init__(self, damping=1e-6, high=0.5, low=1e-3, up=2., down=0.5,
                 min=1e-6, max=1e16):
        if not (damping > 0 and high > 0 and low > 0 and 0 < down < 1
                and up > 1):
            raise ValueError('Adaptive needs damping, high, low > 0, '
                             '0 < down < 1 and up > 1')
        self.damping, self.high, self.low = damping, high, low
        self.up, self.down = up, down
        self.min, self.max = min, max

    def init(self, dtype=torch.float32, device=None):
        return {'damping': torch.tensor(self.damping, dtype=dtype,
                                        device=device)}

    def update(self, state, last, loss, J, D, R):
        return self.step(state, _quality(last, loss, J, D, R))

    def step(self, state, q):
        """The update from a gain ratio ``q``."""
        d = state['damping']
        d = torch.where(q > self.high, d * self.down,
                        torch.where(q > self.low, d, d * self.up))
        return {'damping': torch.clamp(d, self.min, self.max)}


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

    def step(self, state, q):
        """The update from a gain ratio ``q``."""
        radius = 1.0 / state['damping']
        down = state['down']
        radius_new = torch.where(
            q > self.high, self.up * radius,
            torch.where(q > self.low, radius, radius * down))
        down_new = torch.where(q > self.low,
                               torch.full_like(down, self.down0),
                               down * self.factor)
        return {'damping': 1.0 / torch.clamp(radius_new, self.min, self.max),
                'down': torch.clamp(down_new, self.min, self.max)}
