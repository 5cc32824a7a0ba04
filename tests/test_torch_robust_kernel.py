"""The seven robust kernels of ``pypose_tpu_torch.optim.kernel`` against
the JAX package's (``pypose_tpu/optim/kernel.py``) on the same numpy
inputs: the values and the first derivatives (``torch.autograd.grad``
against ``jax.grad``), float32 and float64, on chi2 values from 0 through
both sides of each kernel's switch point.  Held within 1e-6 (float32)
and 1e-12 (float64) of the JAX value, relative to 1 + its magnitude; the
parameter checks raise as the JAX package's asserts do.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pypose_tpu.optim import kernel as jk
from pypose_tpu_torch.optim import kernel as tk
from pypose_tpu_torch.testing import cap_threads

cap_threads()

KERNELS = [('Huber', dict(delta=5.0)), ('Huber', dict(delta=0.5)),
           ('PseudoHuber', dict(delta=2.0)), ('Cauchy', dict(delta=1.5)),
           ('SoftLOne', dict(delta=0.7)), ('Arctan', dict(delta=3.0)),
           ('Tolerant', dict(a=2.0, b=-0.5)), ('Scale', dict(delta=0.3))]
TOL = {'float32': 1e-6, 'float64': 1e-12}


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('name,kw', KERNELS,
                         ids=[f'{n}-{list(k.values())}' for n, k in KERNELS])
def test_value_and_derivative_match_jax(name, kw, dtype):
    x = np.concatenate([[0.0, 1e-8], np.random.default_rng(0).exponential(
        20.0, size=64)]).astype(dtype)
    with jax.enable_x64(dtype == 'float64'):
        jf = getattr(jk, name)(**kw)
        want = np.asarray(jf(jnp.asarray(x)))
        dwant = np.asarray(jax.grad(lambda v: jnp.sum(jf(v)))(jnp.asarray(x)))
    tf = getattr(tk, name)(**kw)
    xt = torch.from_numpy(x).requires_grad_()
    got = tf(xt)
    dgot, = torch.autograd.grad(got.sum(), xt)
    for g, w in ((got, want), (dgot, dwant)):
        g = g.detach().numpy()
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=TOL[dtype] * (1 + np.abs(w).max()))


@pytest.mark.parametrize('make', [
    lambda: tk.Huber(0.0), lambda: tk.PseudoHuber(-1.0),
    lambda: tk.Cauchy(0.0), lambda: tk.SoftLOne(-2.0),
    lambda: tk.Tolerant(a=0.0), lambda: tk.Tolerant(b=1.0),
    lambda: tk.Scale(1.5), lambda: tk.Scale(0.0)])
def test_bad_parameters_raise(make):
    with pytest.raises(ValueError):
        make()
