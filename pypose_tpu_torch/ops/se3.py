r"""Batched SE3 composition and point action as CUDA kernels.

Counterpart of ``pypose_tpu/ops/pallas_se3.py``: :func:`se3_mul_fused` and
:func:`se3_act_fused` launch the kernels of ``csrc/se3.cu`` for CUDA
tensors and run their plain versions, ``lietensor.operation.SE3_Mul`` and
``SE3_Act``, for CPU tensors.  On CUDA they launch or raise.  As in the
JAX package, nothing routes to them: whether the LieTensor operations
should is decided by their time on the card (``PERF.md``).
"""

import ctypes
import functools

import torch

from ..lietensor import operation as op
from ._build import bind, raise_on

# Launches of each kernel in this process.
SE3_MUL_LAUNCHES = 0
SE3_ACT_LAUNCHES = 0

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _kernel_lib():
    sig = [_PTR, _PTR, _INT, _PTR, _PTR]
    return bind('se3', {'ppt_se3_mul': sig, 'ppt_se3_act': sig})


def _check(X, Y, width):
    if X.ndim != 2 or X.shape[1] != 7 or Y.ndim != 2 \
            or Y.shape != (X.shape[0], width):
        raise ValueError(f'expected [N, 7] and [N, {width}], got '
                         f'{tuple(X.shape)} and {tuple(Y.shape)}')
    if X.device != Y.device:
        raise ValueError(f'X is on {X.device}, the other on {Y.device}')


def _launch(fname, X, Y, width):
    if X.device.type != 'cuda':
        raise ValueError(f'unsupported device {X.device}')
    for a in (X, Y):
        if a.dtype != torch.float32:
            raise TypeError(f'{a.dtype} input; the SE3 kernels take float32 '
                            'only')
        if not a.is_contiguous():
            raise ValueError('the SE3 kernels take contiguous inputs')
    out = torch.empty((X.shape[0], width), dtype=torch.float32,
                      device=X.device)
    if X.shape[0] == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(X.device):
        raise_on(lib, getattr(lib, fname)(
            X.data_ptr(), Y.data_ptr(), X.shape[0], out.data_ptr(),
            torch.cuda.current_stream(X.device).cuda_stream), fname)
    return out


def se3_mul_fused(X, Y):
    """SE3 composition ``X * Y`` of ``[N, 7]`` poses (``[t, q xyzw]``)."""
    global SE3_MUL_LAUNCHES
    _check(X, Y, 7)
    if X.device.type == 'cpu':
        return op.SE3_Mul(X, Y)
    out = _launch('ppt_se3_mul', X, Y, 7)
    SE3_MUL_LAUNCHES += 1
    return out


def se3_act_fused(X, p):
    """SE3 action ``X . p`` of ``[N, 7]`` poses on ``[N, 3]`` points."""
    global SE3_ACT_LAUNCHES
    _check(X, p, 3)
    if X.device.type == 'cpu':
        return op.SE3_Act(X, p)
    out = _launch('ppt_se3_act', X, p, 3)
    SE3_ACT_LAUNCHES += 1
    return out
