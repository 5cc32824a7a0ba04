"""Faults planted in the program under test, for the tests that see the
judge find them and for ``readings.py``, which reads them at a cell's own
size.  Each is a context manager that patches the port's ``SparseLM`` or
``pgo_factor`` and restores it on exit; ``phases`` is the number of
``SparseLM.optimize`` calls a solve makes (the traffic's phases).

- ``unchanged_state``: every LM step returns its state unchanged;
- ``unchanged_final_step``: the last step of the last phase does;
- ``skip_final_step``: the last phase runs one step fewer;
- ``half_edges``: half of the edges left out of the factors;
- ``pose_altered``, ``chi2_altered``: the answer altered where it is
  produced (one returned pose moved, the reported chi2 scaled).
"""

from contextlib import contextmanager


@contextmanager
def _patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def _unchanged(core):
    def step(self, params, strat):
        _, _, last, strat, count, its = core(self, params, strat)
        return params, last, last, strat, count, its
    return step


@contextmanager
def unchanged_state(phases):
    from pypose_tpu_torch.optim.sparse import SparseLM
    with _patched(SparseLM, '_core', _unchanged(SparseLM._core)):
        yield


def _final_phase(phases, on_final):
    """An ``optimize`` that calls ``on_final(self, steps)`` for the steps
    of a solve's last phase (the others run as they are)."""
    from pypose_tpu_torch.optim.sparse import SparseLM
    optimize = SparseLM.optimize
    calls = [0]

    def wrapped(self, steps=10, patience=5, decreasing=1e-3):
        calls[0] += 1
        if calls[0] % phases == 0:
            steps = on_final(self, steps)
        return optimize(self, steps=steps, patience=patience,
                        decreasing=decreasing)
    return wrapped


@contextmanager
def skip_final_step(phases):
    from pypose_tpu_torch.optim.sparse import SparseLM
    with _patched(SparseLM, 'optimize',
                  _final_phase(phases, lambda self, steps: steps - 1)):
        yield


@contextmanager
def unchanged_final_step(phases):
    from pypose_tpu_torch.optim.sparse import SparseLM
    core = SparseLM._core
    left = {}

    def on_final(self, steps):
        left[id(self)] = steps
        return steps

    def step(self, params, strat):
        k = left.get(id(self), 0)
        if k:
            left[id(self)] = k - 1
        return (_unchanged(core) if k == 1 else core)(self, params, strat)
    with _patched(SparseLM, 'optimize', _final_phase(phases, on_final)), \
            _patched(SparseLM, '_core', step):
        yield


@contextmanager
def half_edges(phases):
    from pypose_tpu_torch.optim import sparse
    factor = sparse.pgo_factor

    def half(edges, poses, *args, **kwargs):
        k = max(1, edges.shape[0] // 2)
        return factor(edges[:k], poses[:k], *args, **kwargs)
    with _patched(sparse, 'pgo_factor', half):
        yield


def _altered(what):
    @contextmanager
    def plant(phases):
        from pypose_tpu_torch.lietensor.lietensor import LieTensor
        from pypose_tpu_torch.optim.sparse import SparseLM
        optimize = SparseLM.optimize

        def altered(self, *args, **kwargs):
            out = optimize(self, *args, **kwargs)
            if what == 'pose':
                X = self.params['poses'].tensor().clone()
                X[7, 0] += 0.05
                self.params = {'poses': LieTensor(
                    X, ltype=self.params['poses'].ltype)}
            else:
                self.history[-1] *= 1 + 1e-3
            return out
        with _patched(SparseLM, 'optimize', altered):
            yield
    return plant


FAULTS = {'unchanged_state': unchanged_state,
          'unchanged_final_step': unchanged_final_step,
          'skip_final_step': skip_final_step,
          'half_edges': half_edges,
          'pose_altered': _altered('pose'),
          'chi2_altered': _altered('chi2')}
