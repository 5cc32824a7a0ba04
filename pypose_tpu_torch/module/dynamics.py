r"""Discrete-time system dynamics: the base :class:`System`, :class:`LTI`,
:class:`LTV` and :class:`NLS` with its linearization by ``jacrev``.

Counterpart of ``pypose_tpu/module/dynamics.py:16-216``.  The system time
is a 0-dim int64 tensor on the host, advanced by ``forward`` (the JAX
package's forward-hook counter); a host scalar mixes with tensors on any
device and costs no device operation.  Every method also takes the time
explicitly (``t=``), which is how the filters and LQR call them.
"""

import torch

from ..nn import Module
from ..function.linalg import bmv


def _atleast_1d(x):
    return torch.atleast_1d(torch.as_tensor(x))


def _host_time(t):
    return torch.as_tensor(t, dtype=torch.int64 if isinstance(t, int)
                           else None)


class System(Module):
    r"""Base class of discrete-time dynamics: subclasses define
    ``state_transition(state, input, t=None)`` and
    ``observation(state, input, t=None)``; ``forward(state, input)``
    returns both and advances :attr:`systime`.

    Ref: pypose_tpu/module/dynamics.py:20-58.
    """

    def __init__(self):
        super().__init__()
        self._t = torch.zeros((), dtype=torch.int64)

    def forward(self, state, input):
        self.state, self.input = _atleast_1d(state), _atleast_1d(input)
        state = self.state_transition(self.state, self.input)
        obs = self.observation(self.state, self.input)
        self._t = self._t + 1
        return state, obs

    def state_transition(self, state, input, t=None):
        raise NotImplementedError(
            'The users need to define their own state transition method')

    def observation(self, state, input, t=None):
        raise NotImplementedError(
            'The users need to define their own observation method')

    def set_refpoint(self, state=None, input=None, t=None):
        return self

    def reset(self, t=0):
        self._t = torch.as_tensor(t, dtype=torch.int64)
        return self

    @property
    def systime(self):
        return self._t

    @systime.setter
    def systime(self, t):
        self._t = _host_time(t)


class LTI(System):
    r"""Linear time-invariant system
    :math:`x' = Ax + Bu + c_1;\ y = Cx + Du + c_2` with batched matrix
    coefficients.

    Ref: pypose_tpu/module/dynamics.py:61-129.

    Example:
        >>> import torch
        >>> from pypose_tpu_torch.module import LTI
        >>> A = torch.eye(2); B = torch.ones(2, 1)
        >>> C = torch.eye(2); D = torch.zeros(2, 1)
        >>> sys = LTI(A, B, C, D)
        >>> x1, y = sys(torch.zeros(2), torch.ones(1))
        >>> x1
        tensor([1., 1.])
    """

    def __init__(self, A, B, C, D, c1=None, c2=None):
        super().__init__()
        self.register_buffer('_A', A)
        self.register_buffer('_B', B)
        self.register_buffer('_C', C)
        self.register_buffer('_D', D)
        self.register_buffer('_c1', c1)
        self.register_buffer('_c2', c2)

    def state_transition(self, state, input, t=None):
        z = bmv(self.A, state) + bmv(self.B, input)
        return z if self.c1 is None else z + self.c1

    def observation(self, state, input, t=None):
        y = bmv(self.C, state) + bmv(self.D, input)
        return y if self.c2 is None else y + self.c2

    @property
    def A(self):
        return self._A

    @property
    def B(self):
        return self._B

    @property
    def C(self):
        return self._C

    @property
    def D(self):
        return self._D

    @property
    def c1(self):
        return self._c1

    @property
    def c2(self):
        return self._c2


class LTV(LTI):
    r"""Linear time-varying system: subclasses override the ``A`` ... ``D``
    properties as functions of :attr:`systime`.  Ref:
    pypose_tpu/module/dynamics.py:132-143.
    """

    def __init__(self, A=None, B=None, C=None, D=None, c1=None, c2=None):
        super().__init__(A, B, C, D, c1, c2)

    def set_refpoint(self, state=None, input=None, t=None):
        self.systime = t
        return self


class NLS(System):
    r"""Nonlinear system linearized at a reference point: ``A``, ``B``,
    ``C``, ``D`` are ``torch.func.jacrev`` of the (batched)
    ``state_transition`` and ``observation`` at it, so a batched state of
    shape ``(*B, n)`` gives ``(*B, n, *B, n)``; ``c1``, ``c2`` are the
    affine remainders.

    Ref: pypose_tpu/module/dynamics.py:146-184.
    """

    def forward(self, state, input):
        self.state, self.input = _atleast_1d(state), _atleast_1d(input)
        state = self.state_transition(self.state, self.input, self.systime)
        obs = self.observation(self.state, self.input, self.systime)
        self._t = self._t + 1
        return state, obs

    def set_refpoint(self, state=None, input=None, t=None):
        """Ref: pypose_tpu/module/dynamics.py:164-175."""
        self._ref_state = self.state if state is None else _atleast_1d(state)
        self._ref_input = self.input if input is None else _atleast_1d(input)
        self._ref_t = self.systime if t is None else torch.atleast_1d(
            torch.as_tensor(t))
        self._ref_f = self.state_transition(self._ref_state, self._ref_input,
                                            self._ref_t)
        self._ref_g = self.observation(self._ref_state, self._ref_input,
                                       self._ref_t)
        return self

    @property
    def A(self):
        return torch.func.jacrev(lambda x: self.state_transition(
            x, self._ref_input, self._ref_t))(self._ref_state)

    @property
    def B(self):
        return torch.func.jacrev(lambda x: self.state_transition(
            self._ref_state, x, self._ref_t))(self._ref_input)

    @property
    def C(self):
        return torch.func.jacrev(lambda x: self.observation(
            x, self._ref_input, self._ref_t))(self._ref_state)

    @property
    def D(self):
        return torch.func.jacrev(lambda x: self.observation(
            self._ref_state, x, self._ref_t))(self._ref_input)

    @property
    def c1(self):
        return self._ref_f - bmv(self.A, self._ref_state) \
            - bmv(self.B, self._ref_input)

    @property
    def c2(self):
        return self._ref_g - bmv(self.C, self._ref_state) \
            - bmv(self.D, self._ref_input)


def toBTN(vec, T):
    """A vector as batch x time x dim, repeated over time if it has one
    step.  Ref: pypose_tpu/module/dynamics.py:187-197."""
    vec = torch.as_tensor(vec)
    if vec.ndim == 1:
        vec = vec[None]
    if vec.ndim == 2:
        vec = vec[None]
    if vec.shape[1] == 1:
        vec = vec.repeat(1, T, 1)
    return vec


def runsys(system, T, x_traj, u_traj):
    """Roll ``system`` out over T steps from ``x_traj``'s first state under
    ``u_traj``.  Ref: pypose_tpu/module/dynamics.py:200-208."""
    x_traj = toBTN(x_traj, T)
    u_traj = toBTN(u_traj, T)
    xs = [x_traj[..., 0, :]]
    for i in range(T - 1):
        xs.append(system(xs[-1], u_traj[..., i, :])[0])
    return torch.stack(xs, dim=-2)
