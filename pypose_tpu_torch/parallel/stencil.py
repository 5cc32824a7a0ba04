r"""The circulant-stencil CG matvec with its nodes sharded over a ring of
ranks: :func:`sharded_stencil_matvec`.

Counterpart of ``pypose_tpu/parallel/__init__.py:208-281``.  Each global
``roll`` of :meth:`pypose_tpu_torch.ops.spmv.StencilSpMV.couple` becomes a
ring halo exchange through ``torch.distributed.batch_isend_irecv``, and
nothing else: no all-gather, no all-reduce.
"""

import torch
import torch.distributed as dist

from .mesh import axis_size

# Point-to-point messages sent by sharded_stencil_matvec in this process:
# one for each shift that moves data (an isend to one ring neighbour and
# an irecv from the other).
MESSAGES = 0


def sharded_stencil_matvec(stencil, mesh, axis='mp'):
    r"""``matvec(C, D, x) -> y`` of ``stencil`` (a
    :class:`~pypose_tpu_torch.ops.spmv.StencilSpMV`) with the nodes sharded
    over the mesh axis ``axis`` in contiguous blocks of S = N / m rows:
    each rank passes its blocks ``C [n_off, S, t, t]``, ``D [S, t, t]`` and
    ``x [S, t]`` and gets its block of ``y = stencil.matvec(C, D, x)``.

    Per offset ``d = q S + r`` the forward term needs the block of rank
    ``b + q`` and an r-row halo from ``b + q + 1``, and the transpose term
    sends the same back: for graph stencils with ``d < S`` (odometry and
    a loop stride) that is two messages of r rows per offset, the
    reference's two ``ppermute`` s; at one rank nothing is exchanged.
    Messages are counted in :data:`MESSAGES`.  Ref:
    pypose_tpu/parallel/__init__.py:208-281."""
    m = axis_size(mesh, axis)
    N = stencil.N
    if N % m:
        raise ValueError(f'N={N} must divide over the mesh axis ({m} '
                         'ranks)')
    S = N // m
    group = mesh.get_group(axis)
    me = mesh.get_local_rank(axis)
    ring = {d: (divmod(d, S)[0] % m, d % S) for d in stencil.offsets}

    def shift(v, hops):
        """This rank's +hops ring neighbour's ``v`` (same shape)."""
        global MESSAGES
        if hops % m == 0:
            return v
        out = torch.empty_like(v)
        src = dist.get_global_rank(group, (me + hops) % m)
        dst = dist.get_global_rank(group, (me - hops) % m)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, v.contiguous(), dst, group),
                dist.P2POp(dist.irecv, out, src, group)]):
            req.wait()
        MESSAGES += 1
        return out

    def matvec(C, D, x):
        y = torch.einsum('ntu,nu->nt', D, x)
        for k, d in enumerate(stencil.offsets):
            q, r = ring[d]
            # forward: y_b += C_b[k] roll(x, -d)_b
            if r == 0:
                xr = shift(x, q)
            else:
                xr = torch.cat([shift(x[r:], q), shift(x[:r], q + 1)])
            y = y + torch.einsum('ntu,nu->nt', C[k], xr)
            # transpose: y += roll(C[k]^T x, +d)
            back = torch.einsum('ntu,nt->nu', C[k], x)
            if r == 0:
                y = y + shift(back, -q)
            else:
                y = y + torch.cat([shift(back[S - r:], -(q + 1)),
                                   shift(back[:S - r], -q)])
        return y

    return matvec
