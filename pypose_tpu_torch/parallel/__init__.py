r"""Scale-out over a ``torch.distributed`` process group.

Counterpart of ``pypose_tpu/parallel/__init__.py``, whose GSPMD
partitioning becomes explicit SPMD here: one process a rank, the factor
graph's edges (or bundle adjustment's observations) split over the ranks
of a mesh axis, each rank's partial sums completed by ``all_reduce``, and
the solver's control replicated (``parallel/lm.py``).  The sharded path
runs no custom kernel, as the JAX package's runs no Pallas kernel (its
``matvec='generic'`` leaves the stencil kernels out).

Modules: ``mesh`` (:func:`make_mesh`, :func:`shard_leading`,
:func:`replicate`), ``lm`` (:class:`ShardedLM`, :class:`ShardedPGO`),
``ba`` (:class:`ShardedBA`), ``steps`` (:func:`make_pgo_step`,
:func:`make_ba_step`) and ``stencil`` (:func:`sharded_stencil_matvec`).
"""

from .ba import ShardedBA
from .lm import ShardedLM, ShardedPGO
from .mesh import make_mesh, replicate, shard_leading
from .stencil import sharded_stencil_matvec
from .steps import make_ba_step, make_pgo_step

__all__ = ['make_mesh', 'shard_leading', 'replicate', 'ShardedLM',
           'ShardedPGO', 'make_pgo_step', 'make_ba_step', 'ShardedBA',
           'sharded_stencil_matvec']
