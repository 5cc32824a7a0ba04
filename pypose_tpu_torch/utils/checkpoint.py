r"""Save and load trees of tensors, LieTensors and plain values.

Counterpart of ``pypose_tpu/utils/checkpoint.py:29-89``, in the same file
format, so a file either package writes loads in the other: ``<path>.npz``
holding one array per leaf (``arr_0``, ``arr_1``, ... in depth-first
order) and ``__manifest__``, the tree's structure as JSON bytes, where a
LieTensor is ``{"__lie__": <ltype name>}``, an array
``{"__arr__": true}``, a dict ``{"__dict__": {...}}``, a list or tuple
``{"__list__": [...], "__tuple__": <bool>}`` and anything else
``{"__val__": <value>}``.  Tensors are saved from any device and load on
the card unless the caller asks for another device.
"""

import json
import os

import numpy as np
import torch

from ..lietensor.lietensor import LieTensor, liealgebra, liegroup

_LTYPES = {lt.name: lt for lt in liegroup + liealgebra}


def save(path, tree):
    """Save a tree (dicts, lists, tuples, tensors, numpy arrays,
    LieTensors, JSON-able values) to ``path`` (``.npz`` appended unless
    present)."""
    leaves = []
    manifest = _encode(tree, leaves)
    arrays = {f'arr_{i}': v for i, v in enumerate(leaves)}
    np.savez(path if path.endswith('.npz') else path + '.npz',
             __manifest__=np.frombuffer(
                 json.dumps(manifest).encode(), dtype=np.uint8),
             **arrays)


def load(path, device=None):
    """Load a tree saved with :func:`save` (by either package): arrays as
    tensors and LieTensors (with their ltype) on ``device``, the card
    unless the caller asks for another."""
    device = 'cuda' if device is None else device
    if not path.endswith('.npz') and os.path.exists(path + '.npz'):
        path = path + '.npz'
    with np.load(path) as data:
        manifest = json.loads(bytes(data['__manifest__']).decode())
        n = len([k for k in data.files if k.startswith('arr_')])
        leaves = [torch.as_tensor(data[f'arr_{i}'], device=device)
                  for i in range(n)]
    out, rest = _decode(manifest, leaves)
    assert not rest
    return out


def _encode(obj, leaves):
    if isinstance(obj, LieTensor):
        leaves.append(obj.tensor().detach().cpu().numpy())
        return {'__lie__': obj.ltype.name}
    if torch.is_tensor(obj):
        leaves.append(obj.detach().cpu().numpy())
        return {'__arr__': True}
    if isinstance(obj, np.ndarray) or hasattr(obj, 'shape'):
        leaves.append(np.asarray(obj))
        return {'__arr__': True}
    if isinstance(obj, dict):
        return {'__dict__': {k: _encode(v, leaves) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {'__list__': [_encode(v, leaves) for v in obj],
                '__tuple__': isinstance(obj, tuple)}
    return {'__val__': obj}


def _decode(manifest, leaves):
    if '__lie__' in manifest:
        return LieTensor(leaves[0], ltype=_LTYPES[manifest['__lie__']]), \
            leaves[1:]
    if '__arr__' in manifest:
        return leaves[0], leaves[1:]
    if '__dict__' in manifest:
        out = {}
        for k, v in manifest['__dict__'].items():
            out[k], leaves = _decode(v, leaves)
        return out, leaves
    if '__list__' in manifest:
        out = []
        for v in manifest['__list__']:
            item, leaves = _decode(v, leaves)
            out.append(item)
        return tuple(out) if manifest.get('__tuple__') else out, leaves
    return manifest['__val__'], leaves
