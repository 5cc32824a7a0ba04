r"""Group-aware closeness assertion.

Counterpart of ``pypose_tpu/testing/comparison.py:9-30``.
"""

import numpy as np
import torch

from ..lietensor.lietensor import LieTensor


def _numpy(x):
    x = x.tensor() if isinstance(x, LieTensor) else x
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_close(actual, expected, rtol=None, atol=None, **kwargs):
    """Assert closeness; for group LieTensors compares ``(a^-1 b).Log()``
    to 0, so that q and -q count as the same rotation."""
    if isinstance(actual, LieTensor) and isinstance(expected, LieTensor) \
            and not actual.ltype.on_manifold:
        error = _numpy((actual.Inv() @ expected).Log())
        np.testing.assert_allclose(error, np.zeros(error.shape),
                                   rtol=0 if rtol is None else rtol,
                                   atol=1e-5 if atol is None else atol)
        return
    a, b = _numpy(actual), _numpy(expected)
    if rtol is None:
        rtol = 1.3e-6 if a.dtype == np.float32 else 1e-7
    if atol is None:
        atol = 1e-5 if a.dtype == np.float32 else 1e-7
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, **kwargs)
