r"""Device meshes over a ``torch.distributed`` process group, placements,
and the one collective the sharded optimizers use.

Counterpart of ``pypose_tpu/parallel/__init__.py:32-51``.  The JAX
package partitions implicitly (GSPMD); here every rank runs one process
of an explicit SPMD program over a process group, and a
``torch.distributed.device_mesh.DeviceMesh`` names its axes.
:func:`shard_leading` and :func:`replicate` place tensors as DTensors
(``Shard(0)`` / ``Replicate()``), torch's counterpart of a
``NamedSharding``; the optimizers compute on their ``to_local()`` shards,
since ``torch.func`` transforms do not take DTensors.

Every rank builds the same full tensors (from the same seed or file), so
placement moves no data: each rank keeps its own chunk
(``distribute_tensor(..., src_data_rank=None)``).
"""

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils import _pytree as pytree

from ..lietensor.lietensor import LieTensor

# all_reduce calls made by the sharded optimizers and steps in this process
ALL_REDUCES = 0


def _init_one_rank(device_type):
    """A one-rank default process group on an in-memory store, so that
    ``make_mesh()`` works with nothing set up, as the JAX package's does on
    one device: NCCL for CUDA, gloo otherwise."""
    backend = 'nccl' if device_type == 'cuda' else 'gloo'
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh(n_devices=None, axis='dp', device_type=None):
    """1-D mesh named ``axis`` over every rank of the default process
    group, on ``device_type`` (default ``'cuda'``).  Without an
    initialized group it first makes a one-rank group (world size 1, an
    in-memory ``HashStore``).  ``n_devices`` other than the world size
    raises: a mesh never leaves a rank out."""
    device_type = 'cuda' if device_type is None else device_type
    if not dist.is_initialized():
        _init_one_rank(device_type)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f'n_devices={n}, but the process group has {world} '
                         'ranks: a mesh spans every rank of the group')
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))


def axis_size(mesh, axis):
    return mesh.size(mesh.mesh_dim_names.index(axis))


def check_device(mesh, *tensors):
    """Raise unless every tensor lies on the mesh's device type."""
    for t in tensors:
        if t.device.type != mesh.device_type:
            raise ValueError(f'a tensor on {t.device} for a mesh of '
                             f'{mesh.device_type!r} devices')


def _distribute(x, mesh, placements):
    if isinstance(x, LieTensor):
        x = x.tensor()
    return distribute_tensor(torch.as_tensor(x), mesh, placements,
                             src_data_rank=None)


def shard_leading(tree, mesh, axis='dp'):
    """Every leaf as a DTensor with its leading dim sharded over ``axis``
    (``Shard(0)``) and replicated over the mesh's other axes; a LieTensor
    leaf is placed as its storage."""
    pl = [Shard(0) if name == axis else Replicate()
          for name in mesh.mesh_dim_names]
    return pytree.tree_map(lambda x: _distribute(x, mesh, pl), tree,
                           is_leaf=lambda x: isinstance(x, LieTensor))


def replicate(tree, mesh):
    """Every leaf as a DTensor replicated across the mesh."""
    pl = [Replicate()] * mesh.ndim
    return pytree.tree_map(lambda x: _distribute(x, mesh, pl), tree,
                           is_leaf=lambda x: isinstance(x, LieTensor))


def local_rows(x, mesh, axis):
    """This rank's ``Shard(0)`` chunk over ``axis`` of a tensor or a
    LieTensor, as a plain (or Lie) tensor."""
    out = shard_leading(x, mesh, axis).to_local()
    return LieTensor(out, ltype=x.ltype) if isinstance(x, LieTensor) else out


def all_reduce_sum(tree, group):
    """Every leaf summed over ``group``'s ranks by ONE ``all_reduce``: the
    leaves (one dtype) travel as one flat buffer.  Every rank receives the
    same bits."""
    global ALL_REDUCES
    leaves, spec = pytree.tree_flatten(tree)
    dtype = leaves[0].dtype
    if any(v.dtype != dtype for v in leaves):
        raise TypeError('all_reduce_sum takes leaves of one dtype, got '
                        f'{sorted({str(v.dtype) for v in leaves})}')
    flat = torch.cat([v.reshape(-1) for v in leaves])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    ALL_REDUCES += 1
    out, at = [], 0
    for v in leaves:
        out.append(flat[at:at + v.numel()].reshape(v.shape))
        at += v.numel()
    return pytree.tree_unflatten(out, spec)
