r"""Brute-force nearest neighbours: :func:`nn1` (k = 1) and :func:`nnk`.

Counterpart of ``pypose_tpu/ops/pallas_knn.py``.  Each Pallas kernel there
(``_knn1_kernel``, ``_knnk_kernel``) becomes a kernel of ``csrc/knn.cu``,
launched for CUDA tensors by the wrappers here; beside them are their
plain PyTorch versions, which run for CPU tensors and are what tests and
``chip_smoke.py`` compare the kernels with.  On CUDA a wrapper launches
its kernel or raises: it never falls back to the plain version.

The plain versions compute squared distances in the Gram form
``(|a|^2 + |b|^2) - 2 a.b`` with every product and sum rounded once, in
the order of the Pallas kernel (``cross`` summed over the coordinates
from the first), and pick the first index among equal distances, as the
Pallas kernels' first-occurrence argmin and merge do.  Both kernels rank
by ``|b|^2 - 2 a.b`` in FMA form and add ``|a|^2`` after the scan, so on a
near-tie they may pick another neighbour than their plain versions: the
card holds them to :func:`pypose_tpu_torch.testing.nnk_tolerance_failures`
(for ``nn1``, ``nn1_tolerance_failures``).  The distance is clamped at 0
after the neighbours are chosen (``pallas_knn.py:153, 191``).  Indices
are int64 (torch's index type), where the JAX package returns int32.

Both kernels are instantiated for float32 and float64 clouds of 1 to
:data:`MAX_DIM` coordinates.  ``function/geometry.py:_knn_tiled`` routes
k = 1 (not ``largest``) on CUDA to :func:`nn1` and 2 <= k <=
:data:`MAX_K` to :func:`nnk`; clouds of more coordinates raise there.
"""

import ctypes
import functools

import torch

from ._build import bind, raise_on

# Launches of each kernel in this process.
NN1_LAUNCHES = 0
NNK_LAUNCHES = 0
# What csrc/knn.cu is instantiated for: float32 and float64 points of 1 to
# MAX_DIM coordinates, and k up to MAX_K.  Anything else raises on CUDA.
MAX_DIM = 8
MAX_K = 16
_DTYPES = (torch.float32, torch.float64)

# Pairs in one [chunk, N] block of the plain versions (the JAX package's
# 64 Mi budget of function/geometry.py:_knn_tiled).
_PLAIN_PAIRS = 64 * 1024 * 1024

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _kernel_lib():
    return bind('knn', {
        'ppt_nn1_splits': [_INT] * 4,
        'ppt_nn1': [_PTR, _PTR] + [_INT] * 5 + [_PTR] * 5,
        'ppt_nnk_splits': [_INT] * 4,
        'ppt_nnk': [_PTR, _PTR] + [_INT] * 6 + [_PTR] * 5})


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _sqnorm(x):
    """|x|^2 over the last dim, summed from the first coordinate."""
    s = x[..., 0] * x[..., 0]
    for c in range(1, x.shape[-1]):
        s = s + x[..., c] * x[..., c]
    return s


def _gram_d2(a, b, an, bn):
    """[r, N] squared distances in the kernels' order of operations."""
    cross = a[:, None, 0] * b[None, :, 0]
    for c in range(1, a.shape[1]):
        cross += a[:, None, c] * b[None, :, c]
    d2 = an[:, None] + bn[None, :]
    d2 -= cross.mul_(2.0)
    return d2


def _plain_blocks(ref, nbr):
    """Yield the [chunk, N] distance blocks of the plain versions."""
    an, bn = _sqnorm(ref), _sqnorm(nbr)
    chunk = max(128, _PLAIN_PAIRS // nbr.shape[0])
    for s in range(0, ref.shape[0], chunk):
        yield _gram_d2(ref[s:s + chunk], nbr, an[s:s + chunk], bn)


def _nn1_torch(ref, nbr):
    """Plain version of :func:`nn1`: argmin (first occurrence) of each
    ``[chunk, N]`` block, then the clamp."""
    vals, idxs = [], []
    for d2 in _plain_blocks(ref, nbr):
        idx = torch.argmin(d2, dim=1)
        vals.append(d2.gather(1, idx[:, None])[:, 0])
        idxs.append(idx)
    return torch.cat(vals).clamp_min(0.0), torch.cat(idxs)


def _nnk_torch(ref, nbr, k):
    """Plain version of :func:`nnk`: a stable sort of each block's rows,
    so equal distances keep the lower index first, then the clamp."""
    vals, idxs = [], []
    for d2 in _plain_blocks(ref, nbr):
        v, i = torch.sort(d2, dim=1, stable=True)
        # copies: a slice would keep the whole sorted block alive
        vals.append(v[:, :k].contiguous())
        idxs.append(i[:, :k].contiguous())
    return torch.cat(vals).clamp_min(0.0), torch.cat(idxs)


# ---------------------------------------------------------------------------
# the kernels' wrapper
# ---------------------------------------------------------------------------

def _check(ref, nbr):
    if ref.ndim != 2 or nbr.ndim != 2 or ref.shape[1] != nbr.shape[1]:
        raise ValueError(f'ref {tuple(ref.shape)} and nbr '
                         f'{tuple(nbr.shape)} must be [R, D] and [N, D]')
    if nbr.shape[0] == 0:
        raise ValueError('nbr holds no points')
    if ref.device != nbr.device:
        raise ValueError(f'ref is on {ref.device}, nbr on {nbr.device}')


def _check_cuda(ref, nbr, k):
    if ref.device.type != 'cuda':
        raise ValueError(f'unsupported device {ref.device}')
    for name, a in (('ref', ref), ('nbr', nbr)):
        if a.dtype not in _DTYPES or a.dtype != ref.dtype:
            raise TypeError(f'ref is {ref.dtype} and nbr {nbr.dtype}; the '
                            'knn kernels take two float32 or two float64 '
                            'clouds')
        if not a.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if ref.shape[1] > MAX_DIM:
        raise ValueError(f'the knn kernels are instantiated for points of '
                         f'at most {MAX_DIM} coordinates, got '
                         f'{ref.shape[1]}')
    if k > MAX_K:
        raise ValueError(f'k={k} > {MAX_K}, the largest k the nnk kernel '
                         'holds')


def _stream(a):
    return torch.cuda.current_stream(a.device).cuda_stream


def _launch_nn1(ref, nbr):
    """One launch of csrc/knn.cu's nn1 (its scan and merge passes):
    (d2 [R], idx [R] int64)."""
    global NN1_LAUNCHES
    _check_cuda(ref, nbr, 1)
    (R, D), N = ref.shape, nbr.shape[0]
    f64 = int(ref.dtype == torch.float64)
    d2 = torch.empty((R,), dtype=ref.dtype, device=ref.device)
    idx = torch.empty((R,), dtype=torch.int64, device=ref.device)
    if R == 0:
        return d2, idx
    lib = _kernel_lib()
    with torch.cuda.device(ref.device):
        splits = lib.ppt_nn1_splits(R, N, D, f64)
        if splits < 1:
            raise RuntimeError(f'nn1: no split of {N} neighbours for {R} '
                               'rows (device query failed)')
        part_s = torch.empty((splits, R), dtype=ref.dtype,
                             device=ref.device)
        part_i = torch.empty((splits, R), dtype=torch.int32,
                             device=ref.device)
        raise_on(lib, lib.ppt_nn1(
            ref.data_ptr(), nbr.data_ptr(), R, N, D, f64, splits,
            part_s.data_ptr(), part_i.data_ptr(), d2.data_ptr(),
            idx.data_ptr(), _stream(ref)), 'nn1')
    NN1_LAUNCHES += 1
    return d2, idx


def _launch_nnk(ref, nbr, k):
    """One launch of csrc/knn.cu's nnk (its threshold scan and merge
    passes): (d2 [R, k], idx [R, k] int64)."""
    global NNK_LAUNCHES
    _check_cuda(ref, nbr, k)
    (R, D), N = ref.shape, nbr.shape[0]
    f64 = int(ref.dtype == torch.float64)
    d2 = torch.empty((R, k), dtype=ref.dtype, device=ref.device)
    idx = torch.empty((R, k), dtype=torch.int64, device=ref.device)
    if R == 0:
        return d2, idx
    lib = _kernel_lib()
    with torch.cuda.device(ref.device):
        splits = lib.ppt_nnk_splits(R, N, k, f64)
        if splits < 1:
            raise RuntimeError(f'nnk: no split of {N} neighbours for {R} '
                               'rows (device query failed)')
        part_s = torch.empty((splits, k, R), dtype=ref.dtype,
                             device=ref.device)
        part_i = torch.empty((splits, k, R), dtype=torch.int32,
                             device=ref.device)
        raise_on(lib, lib.ppt_nnk(
            ref.data_ptr(), nbr.data_ptr(), R, N, D, k, f64, splits,
            part_s.data_ptr(), part_i.data_ptr(), d2.data_ptr(),
            idx.data_ptr(), _stream(ref)), 'nnk')
    NNK_LAUNCHES += 1
    return d2, idx


def nn1(ref, nbr):
    """Squared distance to, and index of, the nearest ``nbr`` row of each
    ``ref`` row: ``(d2 [R], idx [R] int64)``.

    CUDA tensors launch the register-tiled kernel of ``csrc/knn.cu`` on the
    current stream (two float32 or two float64 clouds, contiguous, at most
    :data:`MAX_DIM` coordinates; anything else raises); CPU tensors run
    :func:`_nn1_torch`.  On a near-tie the two may return different
    neighbours (module docstring).
    """
    _check(ref, nbr)
    if ref.device.type == 'cpu':
        return _nn1_torch(ref, nbr)
    return _launch_nn1(ref, nbr)


def nnk(ref, nbr, k):
    """The ``k`` nearest ``nbr`` rows of each ``ref`` row, ascending by
    (distance, index): ``(d2 [R, k], idx [R, k] int64)``.  ``k = 1`` is
    :func:`nn1`; ``k`` above the number of neighbours raises.

    CUDA tensors launch the threshold-scan kernel of ``csrc/knn.cu`` (as
    :func:`nn1`, and ``k`` at most :data:`MAX_K`); CPU tensors run
    :func:`_nnk_torch`.  On a near-tie the two may return different
    neighbours (module docstring).
    """
    if k == 1:
        d2, idx = nn1(ref, nbr)
        return d2[:, None], idx[:, None]
    _check(ref, nbr)
    if k > nbr.shape[0]:
        raise ValueError(f'k={k} > number of neighbors {nbr.shape[0]}')
    if ref.device.type == 'cpu':
        return _nnk_torch(ref, nbr, k)
    return _launch_nnk(ref, nbr, k)
