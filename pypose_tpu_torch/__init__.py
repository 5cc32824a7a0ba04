r"""pypose_tpu_torch: the PyTorch / CUDA port of ``pypose_tpu``.

Counterpart of ``pypose_tpu/__init__.py:1``.  The package mirrors the JAX
package's file layout; each module names its JAX counterpart.  It imports
torch and numpy, never jax.  This first slice covers the sphere2500
pose-graph path: the SO3/SE3 Lie core (forward), the scalarized PGO
blocks, g2o IO, the stencil normal equations, the whole-solve CG kernel
(``csrc/stencil_cg.cu``) and ``optim.sparse.SparseLM``.
"""

from . import lietensor  # noqa: F401
from . import datasets  # noqa: F401
from . import ops  # noqa: F401
from . import optim  # noqa: F401
from . import testing  # noqa: F401
from .lietensor import (  # noqa: F401
    LieTensor, SO3, so3, SE3, se3, identity_SO3, identity_so3, identity_SE3,
    identity_se3)
