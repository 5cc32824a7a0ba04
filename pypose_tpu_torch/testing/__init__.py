r"""Test helpers: state carried over from the JAX package as numpy, and a
group-aware closeness assertion.

Counterpart of ``pypose_tpu/testing/comparison.py:9-30`` (``assert_close``).
``params_from_numpy`` and ``strategy_state_from_numpy`` let a test start
the port's ``SparseLM`` from exactly the state the JAX package holds:
the caller passes ``np.asarray(X.tensor())`` for each LieTensor, so both
packages begin from bit-identical values.  ``random_stencil_system``
makes the random SPD systems on which the CG kernels are held against
their plain versions, ``instance_checksum`` identifies a generated
pose-graph instance against a recorded anchor, and
``nn1_tolerance_failures`` is the rule that holds the ``nn1`` kernel to
its plain version.
"""

import numpy as np
import torch

from ..lietensor.lietensor import LieTensor, SO3_type, so3_type, SE3_type, \
    se3_type

_LTYPES = {'SO3': SO3_type, 'so3': so3_type, 'SE3': SE3_type,
           'se3': se3_type}


def params_from_numpy(params, ltypes, device=None, dtype=None):
    """Build SparseLM params from numpy arrays.

    Args:
        params: dict ``name -> np.ndarray [N, D]``.
        ltypes: dict ``name -> 'SO3' | 'so3' | 'SE3' | 'se3'``; names not
            listed stay plain tensors.
        device, dtype: of the returned tensors (dtype defaults to the
            array's).
    """
    out = {}
    for name, a in params.items():
        t = torch.tensor(np.asarray(a), device=device, dtype=dtype)
        out[name] = LieTensor(t, ltype=_LTYPES[ltypes[name]]) \
            if name in ltypes else t
    return out


def strategy_state_from_numpy(state, device=None, dtype=None):
    """A strategy state (dict of scalars, e.g. TrustRegion's ``damping``
    and ``down``) as 0-d tensors."""
    return {k: torch.tensor(np.asarray(v), device=device, dtype=dtype)
            for k, v in state.items()}


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


def random_stencil_system(N, loop_offset, n_loops, fixed, generator,
                          device=None):
    """Folded lane-major operands of a random SPD stencil system: an
    odometry chain plus ``n_loops`` loop edges on one circular offset,
    random 6x6 Jacobian blocks, LM damping 0.1, node 0 fixed if
    ``fixed`` (the generator of tests/ops/test_pallas_cg.py:make_system).
    Drawn from ``generator`` on ``device``; the shapes the kernels are
    held at are sphere2500's (2500, 157, 2000, True) and the 100k-pose
    graph's (100_000, 993, 80_000, True), whose offsets are (1, 993).
    Returns (offsets, (b_T, A_T, Minv_T, C_T))."""
    from ..ops.smallinv import blockinv
    from ..ops.spmv import StencilSpMV
    from ..ops.stencil_cg import fold_operands
    t = 6
    ar = torch.arange(N, device=device)
    li = torch.randint(0, N, (n_loops,), generator=generator, device=device)
    edges = torch.cat([torch.stack([ar[:-1], ar[1:]], 1),
                       torch.stack([li, (li + loop_offset) % N], 1)])
    J = torch.randn((edges.shape[0], 6, 2, t), generator=generator,
                    device=device)
    sp = StencilSpMV(edges, N, t, device=device)
    D = torch.zeros((N, t, t), device=device)
    for a in range(2):
        D.index_add_(0, edges[:, a],
                     torch.einsum('edt,edu->etu', J[:, :, a], J[:, :, a]))
    dcorr = 0.1 * torch.diagonal(D, dim1=-2, dim2=-1).clamp(1e-6, 1e32)
    b = torch.randn((N, t), generator=generator, device=device)
    mask = torch.zeros(N, dtype=torch.bool, device=device)
    mask[0] = fixed
    offsets = tuple(sp.offsets)
    return offsets, fold_operands(b, D, dcorr,
                                  blockinv(D + torch.diag_embed(dcorr)),
                                  sp.precompute(J, J), offsets, mask)


def instance_checksum(ds):
    """float64 sums of |nodes| and |poses| and the edge count of a pose
    graph dict (``synthetic_sphere``, ``load_g2o``): enough to tell one
    noise draw from another, on any device."""
    def abs_sum(X):
        return float(X.tensor().detach().double().abs().sum())
    return {'nodes_abs_sum': abs_sum(ds['nodes']),
            'poses_abs_sum': abs_sum(ds['poses']),
            'n_edges': int(ds['edges'].shape[0])}


def nn1_tolerance_failures(ref, nbr, d2, idx, idx_plain, rtol=1e-6,
                           atol=1e-6):
    """Where a nearest-neighbour result ``(d2, idx)`` breaks the rule that
    holds the ``nn1`` kernel to its plain version, whose indices are
    ``idx_plain``.  In float64, with ``a`` a row of ``ref``, ``b`` its
    returned neighbour and ``b'`` the plain version's, and
    ``tol = rtol (|a|^2 + |b|^2) + atol``:

    - the index: ``idx == idx_plain``, or a near-tie,
      ``| |a - b|^2 - |a - b'|^2 | <= tol``;
    - the distance: ``|d2 - |a - b|^2| <= tol``.

    The kernel ranks by FMA-form float32 arithmetic and the plain version
    by separately rounded products, so the two may pick different
    neighbours where the distances agree to within their rounding.
    Returns counts of rows, as ints: ``differ`` (indices differ),
    ``index_failures``, ``d2_failures``, and ``max_d2_err`` (float)."""
    a = ref.double()
    b = nbr.double()[idx]
    bp = nbr.double()[idx_plain]
    dist = ((a - b) ** 2).sum(-1)
    dist_p = ((a - bp) ** 2).sum(-1)
    tol = rtol * ((a * a).sum(-1) + (b * b).sum(-1)) + atol
    differ = idx != idx_plain
    err = (d2.double() - dist).abs()
    return {'differ': int(differ.sum()),
            'index_failures': int((differ & ((dist - dist_p).abs() > tol))
                                  .sum()),
            'd2_failures': int((err > tol).sum()),
            'max_d2_err': float(err.max()) if err.numel() else 0.0}
