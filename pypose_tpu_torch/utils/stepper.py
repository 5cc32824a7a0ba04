r"""Loop controller used by ICP.

Counterpart of ``pypose_tpu/utils/stepper.py:6-57``, with the same tol,
max-steps and patience rules.  A loss may be a torch tensor on any
device: :meth:`ReduceToBason.step` reads it to the host, once a step.
"""

import numpy as np
import torch


class _Stepper:
    def __init__(self, max_steps, verbose=False):
        self.max_steps, self.verbose = max_steps, verbose
        self.reset()

    def continual(self):
        return self._continual

    def reset(self):
        self.last = float('inf')
        self.steps, self._continual = 0, True


class ReduceToBason(_Stepper):
    r"""Stop when every loss is below ``tol``, after ``steps`` steps, or
    after ``patience`` consecutive steps whose relative decrease
    ``(last - loss) / loss`` is below ``decreasing`` for every loss."""

    def __init__(self, steps, patience=5, decreasing=1e-3, tol=1e-5,
                 verbose=False):
        super().__init__(steps, verbose)
        self.decreasing, self.tol = decreasing, tol
        self.patience, self.patience_count = patience, 0

    def reset(self):
        super().reset()
        self.patience_count = 0

    def step(self, loss):
        if torch.is_tensor(loss):
            loss = loss.detach().cpu().numpy()
        loss = np.asarray(loss)
        if self.verbose:
            print('ReduceToBason step', self.steps, 'loss', loss)
        self.steps = self.steps + 1
        if np.all(loss < self.tol):
            self._continual = False
            if self.verbose:
                print('ReduceToBason: Loss tol reached, Quiting..')
        if self.steps >= self.max_steps:
            self._continual = False
            if self.verbose:
                print('ReduceToBason: Maximum steps reached, Quiting..')
        if np.all((self.last - loss) / loss < self.decreasing):
            self.patience_count = self.patience_count + 1
        else:
            self.patience_count = 0
        self.last = loss
        if self.patience_count >= self.patience:
            self._continual = False
            if self.verbose:
                print('ReduceToBason: Maximum patience steps reached, '
                      'Quiting..')
