r"""pypose_tpu_torch: the PyTorch / CUDA port of ``pypose_tpu``.

Counterpart of ``pypose_tpu/__init__.py:1``.  The package mirrors the JAX
package's file layout; each module names its JAX counterpart.  It imports
torch and numpy, never jax.  It covers two paths:

- factor graphs (sphere2500, 100k poses, chain-dominated and random-loop
  graphs, over SE3 and, on the same topologies, SO3, RxSO3 and Sim3): the
  Lie core of all four groups, differentiable (the 32 autograd Functions
  of ``lietensor/operation.py``; LieTensor a torch pytree node; ``nn``
  and ``func``), with its random factories, views
  and matrix conversions, the scalarized SE3 PGO blocks, g2o IO and the
  synthetic sphere graph, the stencil and coupling-block normal
  equations (``ops.spmv``), the stencil CG kernels
  (``csrc/stencil_cg.cu`` whole-solve, ``csrc/stencil_cg_fused.cu`` for
  systems past its L2 budget, ``csrc/stencil_cg_tiled.cu`` beside it),
  the einsum CG (``optim.solver``) with block-Jacobi or the block cyclic
  reduction chain preconditioner (``ops.block_tridiag``), and
  ``optim.sparse.SparseLM``, which picks among them and takes
  closed-form or autodiff Jacobians and the robust kernels of
  ``optim.kernel``;
- bundle adjustment: ``optim.ba.BundleAdjustment`` (dense Schur or
  Schur-CG, camera sums in a fixed order), the scalarized BAL
  reprojection blocks, BAL IO through the native tokenizer
  (``native/``, which ``load_g2o`` takes too), ``synthetic_bal`` and the
  projections of ``function.geometry``;
- point clouds: ``module.ICP`` over ``function.geometry.knn`` (the
  nearest-neighbour kernels of ``csrc/knn.cu``), ``svdtf`` and ``svdstf``, with
  ``utils.ReduceToBason``, and the filters (``nbr_filter``,
  ``random_filter``, ``voxel_filter``, ``knn_filter``).  The SE3
  composition and action kernels of ``csrc/se3.cu`` (``ops.se3``) sit
  beside them, not routed;
- IMU preintegration: ``module.IMUPreintegrator`` over the O(log N)
  scans of ``basics`` (``cumops``, ``cummul``, ``cumprod``) and the
  closed-form covariance, with KITTI oxts IO in ``datasets``;
- dense least squares: ``optim.GN`` and ``optim.LM`` with their
  correctors, ``optim.scheduler.StopOnPlateau``,
  ``optim.make_batch_optimizer`` (``torch.func.vmap`` over independent
  problems) and ``optim.least_squares`` (differentiable by the implicit
  function theorem), with ``function.linalg``;
- trajectory evaluation and the support modules: ``metric`` (``ape``,
  ``rpe``), ``chspline`` and ``bspline`` (``function/spline.py``),
  ``sparse`` (BSR x BSC products and the BSR matvec in fixed-order
  sums), ``utils`` (``Timer``, ``checkpoint`` in the JAX package's file
  format, ``collect_env``), ``testing.comparison``, and ``examples``:
  the 15 scripts of the JAX package's ``examples/``, run as
  ``python -m pypose_tpu_torch.examples.<name>``.
"""

__version__ = '0.1.0'

from . import lietensor  # noqa: F401
from . import datasets  # noqa: F401
from . import ops  # noqa: F401
from . import optim  # noqa: F401
from . import function  # noqa: F401
from . import utils  # noqa: F401
from . import module  # noqa: F401
from . import testing  # noqa: F401
from . import nn  # noqa: F401
from . import func  # noqa: F401
from . import native  # noqa: F401
from . import basics  # noqa: F401
from . import metric  # noqa: F401
from . import sparse  # noqa: F401
from . import parallel  # noqa: F401
from .sparse import (  # noqa: F401
    bsr_bsc_matmul, bsr_matvec, dense_to_bsr, dense_to_bsc)
from .basics import (  # noqa: F401
    pm, cumops, cummul, cumprod, cumops_, cummul_, cumprod_)
from .nn import Parameter, Module  # noqa: F401
from .lietensor import (  # noqa: F401
    LieTensor, SO3_type, so3_type, SE3_type, se3_type, Sim3_type, sim3_type,
    RxSO3_type, rxso3_type, liegroup, liealgebra, SO3, so3, SE3, se3, Sim3, sim3, RxSO3, rxso3, identity_SO3,
    identity_so3, identity_SE3, identity_se3, identity_Sim3, identity_sim3,
    identity_RxSO3, identity_rxso3, randn_SO3, randn_so3, randn_SE3,
    randn_se3, randn_Sim3, randn_sim3, randn_RxSO3, randn_rxso3, randn_like,
    identity_like, Exp, Log, Inv, Mul, Retr, Act, Adj, AdjT, Jinvp, Jr,
    euler2SO3, mat2SO3, mat2SE3, mat2Sim3, mat2RxSO3, from_matrix,
    tensor, translation, rotation, scale, matrix, euler, quat2unit,
    vec2skew, add, add_, mul, stack, cat, concat, split)
from .function import (  # noqa: F401
    KNNResult, cart2homo, homo2cart, point2pixel, pixel2point, reprojerr,
    knn, svdtf, svdstf, is_lietensor, is_SE3, hasnan, nbr_filter,
    random_filter, voxel_filter, knn_filter, bvv, bmv, bvmv, chspline,
    bspline)
from .module import ICP, IMUPreintegrator  # noqa: F401
from .module.loss import geodesic_loss  # noqa: F401
from .utils import ReduceToBason  # noqa: F401
