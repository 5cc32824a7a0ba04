r"""Projections, nearest neighbours, rigid or similarity alignment and
point-cloud filters: ``cart2homo``, ``homo2cart``, ``point2pixel``,
``pixel2point``, ``reprojerr``, ``knn``, ``svdtf``, ``svdstf``,
``nbr_filter``, ``random_filter``, ``voxel_filter`` and ``knn_filter``.

Counterpart of ``pypose_tpu/function/geometry.py``.  ``knn``
keeps the JAX package's routes: the dense distance matrix up to 64 Mi
pairs, above it (or with an explicit ``chunk``) :func:`_knn_tiled`, which
sends k = 1 (not ``largest``) on CUDA to the ``nn1`` kernel and
2 <= k <= 16 to the ``nnk`` kernel (in place of the JAX package's TPU
test; float32 or float64 clouds of at most 8 coordinates, others raise)
and takes the chunked Gram form everywhere else.
Indices are int64 (torch's index type), where the JAX package returns
int32.  Ties go to the lower index, as ``jax.lax.top_k`` gives them,
through stable sorts on the CPU and the kernels' strict comparisons on
CUDA.
"""

from collections import namedtuple

import torch

from ..lietensor.convert import mat2SE3, mat2Sim3
from ..lietensor.lietensor import LieTensor
from ..ops import knn as knn_ops
from ..optim.sparse import require_full_fp32

KNNResult = namedtuple('KNNResult', ['values', 'indices'])

def cart2homo(coordinates):
    """Cartesian ``(*, N)`` -> homogeneous ``(*, N+1)`` (a column of
    ones appended)."""
    if isinstance(coordinates, LieTensor):
        coordinates = coordinates.tensor()
    return torch.cat([coordinates, torch.ones_like(coordinates[..., :1])],
                     dim=-1)


def homo2cart(coordinates):
    """Homogeneous ``(*, N+1)`` -> cartesian ``(*, N)``: divides by the
    last coordinate, whose magnitude is held at least float's ``tiny`` and
    whose sign at 0 counts as +."""
    last = coordinates[..., -1:]
    tiny = torch.finfo(coordinates.dtype).tiny
    denum = torch.where(last >= 0, 1.0, -1.0) * torch.clamp(last.abs(),
                                                             min=tiny)
    return coordinates[..., :-1] / denum


def point2pixel(points, intrinsics, extrinsics=None):
    """Project points ``(*, N, 3)`` to pixels ``(*, N, 2)`` through the
    pinhole ``intrinsics`` ``(*, 3, 3)``, after the SE3 ``extrinsics``
    ``(*, 7)`` if given."""
    assert points.shape[-1] == 3, 'Points shape incorrect'
    assert intrinsics.shape[-1] == intrinsics.shape[-2] == 3, \
        'Intrinsics shape incorrect.'
    if extrinsics is not None:
        assert isinstance(extrinsics, LieTensor) and \
            extrinsics.shape[-1] == 7, 'Type incorrect.'
        points = extrinsics.unsqueeze(-2) @ points
    return homo2cart(points @ intrinsics.mT)


def pixel2point(pixels, depth, intrinsics):
    """Back-project pixels ``(*, N, 2)`` at ``depth`` ``(*, N)`` through
    the pinhole ``intrinsics`` to points ``(*, N, 3)``."""
    assert pixels.shape[-1] == 2, 'Pixels shape incorrect'
    assert depth.shape[-1] == pixels.shape[-2], \
        'Depth shape does not match pixels'
    assert intrinsics.shape[-1] == intrinsics.shape[-2] == 3, \
        'Intrinsics shape incorrect.'
    fx, fy = intrinsics[..., 0, 0], intrinsics[..., 1, 1]
    cx, cy = intrinsics[..., 0, 2], intrinsics[..., 1, 2]
    x = (pixels[..., 0] - cx[..., None]) * depth / fx[..., None]
    y = (pixels[..., 1] - cy[..., None]) * depth / fy[..., None]
    return torch.stack([x, y, depth], dim=-1)


def reprojerr(points, pixels, intrinsics, extrinsics=None, reduction='none'):
    """Reprojection error of ``points`` against ``pixels``: per point
    (``'none'``, ``(*, N, 2)``), its norm (``'norm'``) or the sum of its
    two components (``'sum'``)."""
    assert points.shape[-1] == 3 and pixels.shape[-1] == 2 and \
        intrinsics.shape[-1] == intrinsics.shape[-2] == 3, \
        'Shape not compatible.'
    assert reduction in {'norm', 'sum', 'none'}, \
        "Reduction method can only be 'norm'|'sum'|'none'."
    err = point2pixel(points, intrinsics, extrinsics) - pixels
    if reduction == 'norm':
        return torch.linalg.norm(err, dim=-1)
    if reduction == 'sum':
        return torch.sum(err, dim=-1)
    return err


# Above this many pairs knn streams [chunk, N] tiles (geometry.py:127).
_DENSE_PAIRS = 64 * 1024 * 1024


def knn(ref, nbr, k=1, ord=2, dim=-1, largest=False, sorted=True,
        chunk=None):
    """The ``k`` nearest (or, with ``largest``, farthest) ``nbr`` points
    ``(*, N, D)`` of each ``ref`` point ``(*, R, D)`` in the ``ord`` norm:
    ``KNNResult(values (*, R, k), indices (*, R, k))``, ascending
    (descending with ``largest``).  ``sorted`` is accepted for the
    signature's sake; results are always sorted.

    Two-dimensional clouds with ``ord=2`` above 64 Mi pairs, or with an
    explicit ``chunk``, go through :func:`_knn_tiled`; everything else
    forms the dense ``(*, R, N)`` distance matrix.  On CUDA that route
    takes the ``nn1`` kernel for k = 1 and the ``nnk`` kernel for
    2 <= k <= ``ops.knn.MAX_K`` (not ``largest``), which take float32 and
    float64 clouds of at most ``ops.knn.MAX_DIM`` coordinates and raise
    for others, and the chunked Gram path for larger k and ``largest``.

    Example:
        >>> import torch
        >>> from pypose_tpu_torch.function.geometry import knn
        >>> ref = torch.tensor([[0., 0., 0.]])
        >>> nbr = torch.tensor([[5., 0., 0.], [1., 0., 0.], [3., 0., 0.]])
        >>> knn(ref, nbr, k=2).indices
        tensor([[1, 2]])
    """
    R, N = ref.shape[-2], nbr.shape[-2]
    flat = ref.ndim == 2 and nbr.ndim == 2
    auto_tiled = chunk is None and ord == 2 and flat and R * N > _DENSE_PAIRS
    if (chunk is not None or auto_tiled) and ord == 2 and flat:
        if chunk is None:
            chunk = max(128, _DENSE_PAIRS // max(N, 1))
        return _knn_tiled(ref, nbr, k, largest, chunk)
    diff = ref[..., :, None, :] - nbr[..., None, :, :]
    dist = torch.linalg.vector_norm(diff, ord=ord, dim=dim)
    values, indices = torch.sort(dist, dim=-1, descending=largest,
                                 stable=True)
    return KNNResult(values[..., :k], indices[..., :k])


def _knn_tiled(ref, nbr, k, largest, chunk):
    """Gram-form kNN of ``[R, D]`` in ``[N, D]``: on CUDA, k = 1 (not
    ``largest``) launches the ``nn1`` kernel and 2 <= k <= ``MAX_K`` the
    ``nnk`` kernel (which raise for clouds they are not instantiated for);
    everything else takes :func:`_knn_gram`."""
    N = nbr.shape[0]
    if (ref.device.type == 'cuda' and not largest
            and 1 <= k <= min(N, knn_ops.MAX_K)):
        d2, idx = knn_ops.nnk(ref.contiguous(), nbr.contiguous(), k)
        return KNNResult(torch.sqrt(d2), idx)
    return _knn_gram(ref, nbr, k, largest, chunk)


def _knn_gram(ref, nbr, k, largest, chunk):
    """``[chunk, N]`` Gram-form distance tiles, one ref chunk at a time
    (the JAX package's ``lax.map`` path, which clamps d^2 at 0 before it
    picks).  Float32 Gram cancellation can only swap neighbours whose true
    distances differ by less."""
    require_full_fp32(ref.device)
    R = ref.shape[0]
    nbr2 = torch.sum(nbr * nbr, dim=-1)
    values, indices = [], []
    for s in range(0, R, chunk):
        tile = ref[s:s + chunk]
        g = torch.matmul(tile, nbr.T)
        d2 = (torch.sum(tile * tile, dim=-1)[:, None] + nbr2[None, :]
              - 2.0 * g).clamp_min(0.0)
        if k == 1:
            idx = (torch.argmax(d2, dim=-1) if largest
                   else torch.argmin(d2, dim=-1))[:, None]
            val = d2.gather(-1, idx)
        else:
            val, idx = torch.sort(d2, dim=-1, descending=largest,
                                  stable=True)
            # a copy: a slice would keep the whole [chunk, N] block alive
            val, idx = val[:, :k], idx[:, :k].contiguous()
        values.append(torch.sqrt(val))
        indices.append(idx)
    return KNNResult(torch.cat(values), torch.cat(indices))


def svdtf(source, target):
    r"""Rigid alignment (Kabsch): the SE3 ``T`` minimizing
    :math:`\sum_i \|T \cdot s_i - t_i\|^2` for ``(*, N, 3)`` clouds, where
    a rotation with det(R) = -1 (within 1e-6) is negated, as in the JAX
    package.  The 3x3 SVD and determinant go through torch.linalg (on CUDA,
    cuSOLVER, which reads back to the host); TF32 is turned off.

    Example:
        >>> import torch
        >>> from pypose_tpu_torch.function.geometry import svdtf
        >>> src = torch.tensor([[0., 0, 0], [1, 0, 0], [0, 2, 0], [0, 0, 3]])
        >>> T = svdtf(src, src + torch.tensor([1., 2., 3.])).tensor()
        >>> bool(torch.allclose(T, torch.tensor([1., 2., 3., 0, 0, 0, 1]),
        ...                     atol=1e-6))
        True
    """
    if source.shape[-2] != target.shape[-2]:
        raise ValueError('The number of points N has to be the same for '
                         'both point clouds.')
    require_full_fp32(source.device)
    ctnsource = source.mean(dim=-2, keepdim=True)
    ctntarget = target.mean(dim=-2, keepdim=True)
    M = torch.einsum('...Na,...Nb->...ab', target - ctntarget,
                     source - ctnsource)
    U, _, Vh = torch.linalg.svd(M)
    R = U @ Vh
    flip = torch.abs(torch.linalg.det(R) + 1) < 1e-6
    R = torch.where(flip[..., None, None], -R, R)
    t = ctntarget.mT - R @ ctnsource.mT
    return mat2SE3(torch.cat([R, t], dim=-1), check=False)


def svdstf(source, target, with_scale=True):
    r"""Similarity alignment (Umeyama): the Sim3 ``T`` minimizing
    :math:`\sum_i \|T \cdot s_i - t_i\|^2` for ``(*, N, 3)`` clouds; with
    ``with_scale=False`` the scale is 1.  The 3x3 SVD and determinant go
    through torch.linalg; TF32 is turned off.

    Example:
        >>> import torch
        >>> from pypose_tpu_torch.function.geometry import svdstf
        >>> src = torch.tensor([[0., 0, 0], [1, 0, 0], [0, 2, 0], [0, 0, 3]])
        >>> T = svdstf(src, 2 * src + torch.tensor([1., 2., 3.])).tensor()
        >>> bool(torch.allclose(
        ...     T, torch.tensor([1., 2., 3., 0, 0, 0, 1, 2]), atol=1e-6))
        True
    """
    if source.shape[-2] != target.shape[-2]:
        raise ValueError('The number of points N has to be the same for '
                         'both point clouds.')
    if source.shape[-1] != 3 or target.shape[-1] != 3:
        raise ValueError('svdstf takes (*, N, 3) clouds')
    require_full_fp32(source.device)
    N = source.shape[-2]
    ctnsource = source.mean(dim=-2, keepdim=True)
    ctntarget = target.mean(dim=-2, keepdim=True)
    source_ = source - ctnsource
    target_ = target - ctntarget
    U, D, V = torch.linalg.svd(target_.mT @ source_ / N)
    M = torch.eye(3, dtype=U.dtype, device=U.device).repeat(
        U.shape[:-2] + (1, 1))
    M[..., -1, -1] = torch.sign(torch.linalg.det(U @ V))
    if with_scale:
        var_source = (torch.linalg.norm(source_, dim=-1) ** 2).mean(
            dim=-1, keepdim=True)
        scale = torch.sum(torch.diagonal(M, dim1=-2, dim2=-1) * D, dim=-1,
                          keepdim=True) / var_source
    else:
        scale = torch.ones_like(D[..., 0:1])
    scale = scale[..., None]
    R = U @ M @ V
    t = ctntarget.mT - scale * R @ ctnsource.mT
    return mat2Sim3(torch.cat([scale * R, t], dim=-1), check=False)


def nbr_filter(points, nbr, radius, pdim=None, ord=2, return_mask=False):
    """Keep the points with at least ``nbr`` neighbours within ``radius``
    (a dense distance matrix over the first ``pdim`` coordinates; the
    output size depends on the data).

    Ref: pypose_tpu/function/geometry.py:271.
    """
    assert points.dim() == 2, 'The point cloud dimension has to be 2.'
    pdim = points.shape[-1] if pdim is None else pdim
    assert points.shape[-1] >= pdim, \
        'The last dim of points should not less than pdim.'
    diff = points[:, None, :pdim] - points[None, :, :pdim]
    count = torch.sum(torch.linalg.vector_norm(diff, ord=ord, dim=-1)
                      <= radius, dim=-1) - 1
    mask = count >= nbr
    out = points[mask]
    if return_mask:
        return out, mask
    return out


def random_filter(points, num, generator=None):
    """Randomly sample ``num`` points (a permutation drawn from
    ``generator``, a ``torch.Generator``, on its device and then moved,
    so one CPU generator gives the same points on any device; torch's
    global generator when None).

    Ref: pypose_tpu/function/geometry.py:292 (a ``jax.random`` key there).
    """
    assert points.shape[-1] >= 1
    assert num <= points.shape[-2], \
        'Number of points to sample must not larger than the number of ' \
        'input points.'
    dev = points.device if generator is None else generator.device
    perm = torch.randperm(points.shape[-2], generator=generator, device=dev)
    return points[..., perm[:num].to(points.device), :]


def voxel_filter(points, voxel, random=False, generator=None):
    """Voxel downsampling: the mean (or, if ``random``, one point drawn
    with ``generator``) of each occupied voxel.  A host path through
    numpy, as in the JAX package: the output size depends on the data.
    ``voxel``: a sequence, array or tensor (on any device).  The result
    comes back in ``points``' dtype on its device.

    Ref: pypose_tpu/function/geometry.py:305.

    Example:
        >>> import torch, pypose_tpu_torch as pp
        >>> pts = torch.tensor([[0., 0., 0.], [0.2, 0., 0.], [5., 5., 5.]])
        >>> pp.voxel_filter(pts, [1., 1., 1.])     # two occupied voxels
        tensor([[0.1000, 0.0000, 0.0000],
                [5.0000, 5.0000, 5.0000]])
    """
    import numpy as np
    assert points.dim() == 2, 'The point cloud dimension has to be 2.'
    pts = points.detach().cpu().numpy()
    voxel = voxel.detach().cpu().numpy() if torch.is_tensor(voxel) \
        else np.asarray(voxel)
    D, vdim = pts.shape[-1], len(voxel)
    assert D >= vdim
    assert all(v != 0 for v in voxel), 'Voxel size should be nonzero.'
    minp = pts[:, :vdim].min(axis=0)
    indices = ((pts[:, :vdim] - minp) // voxel).astype(np.int64)
    uniq, inverse, counts = np.unique(indices, axis=0, return_inverse=True,
                                      return_counts=True)
    inverse = inverse.reshape(-1)

    def out(a):
        return torch.as_tensor(a, dtype=points.dtype, device=points.device)
    if random:
        dev = 'cpu' if generator is None else generator.device
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator,
                                 device=dev))
        rng = np.random.default_rng(seed)
        order = np.argsort(inverse, kind='stable')
        starts = np.cumsum(counts) - counts
        picks = starts + rng.integers(0, counts)
        return out(pts[order][picks])
    sums = np.zeros((len(uniq), D))
    np.add.at(sums, inverse, pts)
    return out(sums / counts[:, None])


def knn_filter(points, k, pdim=None, radius=None, ord=2):
    """Replace each point by the mean of its k + 1 nearest neighbours
    (itself included), dropping first, if ``radius`` is given, the points
    with fewer than k neighbours within it.  The dense distance matrix and
    a top-(k + 1) of its negation, as the JAX package computes it (not
    :func:`knn`).

    Ref: pypose_tpu/function/geometry.py:342.
    """
    if radius is not None:
        assert points.dim() == 2, \
            'The points dimension has to be 2 given radius.'
    else:
        assert points.dim() >= 2
    pdim = points.shape[-1] if pdim is None else pdim
    assert points.shape[-1] >= pdim
    diff = points[..., :, None, :pdim] - points[..., None, :, :pdim]
    dist = torch.linalg.vector_norm(diff, ord=ord, dim=-1)
    if radius is not None:
        rmask = torch.sum(dist <= radius, dim=-1) - 1 >= k
        points, dist = points[rmask], dist[rmask][:, rmask]
    _, idx = torch.topk(-dist, k + 1, dim=-1)
    return points[idx].mean(dim=-2)
