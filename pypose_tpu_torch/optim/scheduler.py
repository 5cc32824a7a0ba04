r"""Optimization schedulers.

Counterpart of ``pypose_tpu/optim/scheduler.py``.  ``StopOnPlateau``
steps an optimizer from the host, one host read a step, or, when not
verbose, hands the whole schedule to the optimizer's own ``optimize``
(one host read in all).
"""


class _Scheduler:
    """Base scheduler.  Ref: pypose_tpu/optim/scheduler.py:_Scheduler."""

    class Continual:
        def __init__(self, sched):
            self.sched = sched

        def __call__(self):
            return self.sched.iscontinual()

        def __bool__(self):
            return self.sched.iscontinual()

    def __init__(self, optimizer, max_steps, verbose=False):
        self.optimizer, self.verbose = optimizer, verbose
        self.max_steps, self.steps = max_steps, 0
        self.continual = self.Continual(self)
        self._continual = True

    def iscontinual(self):
        return self._continual

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()
                if k not in ('optimizer', 'continual')}

    def load_state_dict(self, state_dict):
        self.__dict__.update(state_dict)
        self.continual = self.Continual(self)


class StopOnPlateau(_Scheduler):
    r"""Stops when the loss falls by less than ``decreasing`` for
    ``patience`` consecutive steps, when ``steps`` is reached, or when the
    optimizer rejected a step that also fell by less than ``decreasing``
    (the reference quits on any rejection).

    Ref: pypose_tpu/optim/scheduler.py:40.

    Example:
        >>> import torch, pypose_tpu_torch as pp
        >>> from pypose_tpu_torch.optim.scheduler import StopOnPlateau
        >>> class PoseInv(pp.Module):
        ...     def __init__(self):
        ...         super().__init__()
        ...         self.pose = pp.Parameter(pp.identity_se3(2))
        ...     def forward(self, input):
        ...         return (self.pose.Exp() @ input).Log().tensor()
        >>> target = pp.randn_SE3(2, sigma=0.4,
        ...                       generator=torch.Generator().manual_seed(0))
        >>> opt = pp.optim.LM(PoseInv())
        >>> sched = StopOnPlateau(opt, steps=10, patience=3)
        >>> sched.optimize(target) < 1e-7
        True
    """

    def __init__(self, optimizer, steps, patience=5, decreasing=1e-3,
                 verbose=False):
        super().__init__(optimizer, steps, verbose)
        self.decreasing = decreasing
        self.patience, self.patience_count = patience, 0

    def step(self, loss=None):
        assert self.optimizer.loss is not None, \
            'scheduler.step() should be called after optimizer.step()'
        self.steps = self.steps + 1
        if self.verbose:
            print('StopOnPlateau on step {} Loss {:.6e} --> Loss {:.6e} '
                  '(reduction/loss: {:.4e}).'.format(
                      self.steps, self.optimizer.last, self.optimizer.loss,
                      (self.optimizer.last - self.optimizer.loss)
                      / (self.optimizer.last + 1e-31)))
        if self.steps >= self.max_steps:
            self._continual = False
            if self.verbose:
                print('StopOnPlateau: Maximum steps reached, Quitting..')
        if self.optimizer.last - self.optimizer.loss < self.decreasing:
            self.patience_count = self.patience_count + 1
        else:
            self.patience_count = 0
        if self.patience_count >= self.patience:
            self._continual = False
            if self.verbose:
                print('StopOnPlateau: Maximum patience steps reached, '
                      'Quitting..')
        if getattr(self.optimizer, 'reject_count', 0) > 0 and \
                self.optimizer.last - self.optimizer.loss < self.decreasing:
            self._continual = False
            if self.verbose:
                print('StopOnPlateau: Maximum rejected steps reached, '
                      'Quitting..')

    def optimize(self, input=None, target=None, weight=None):
        """The whole loop: the optimizer's own ``optimize`` when it has
        one and this scheduler is not verbose, else host steps (one host
        read a step, with printing).  Ref:
        pypose_tpu/optim/scheduler.py:105-124."""
        if not self.verbose and hasattr(self.optimizer, 'optimize'):
            remaining = self.max_steps - self.steps
            loss = self.optimizer.optimize(
                input, target, weight, steps=remaining,
                patience=self.patience, decreasing=self.decreasing)
            self.steps += len(getattr(self.optimizer, 'history', [])) \
                or remaining
            self._continual = False
            return loss
        while self.continual():
            loss = self.optimizer.step(input, target, weight)
            self.step(loss)
        return loss
