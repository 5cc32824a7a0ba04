r"""Circulant-stencil SpMV for factor-graph normal equations.

Counterpart of ``pypose_tpu/ops/spmv.py:35-49, 202-287`` (the coupling
blocks and ``StencilSpMV``; ``CouplingSpMV`` waits for the large-graph
slice).  For an arity-2 factor graph,

    A = D + sum_e [ C_e (i <- j) + C_e^T (j <- i) ],   C_e = J_i^T W J_j.

Pose graphs are near-circulant: odometry edges have offset j - i = 1 and
loop closures cluster on few offsets.  Grouping edges by circular offset
turns the coupling part of ``A x`` into offset stencils,

    y += C_d x_{n+d};   y_{n+d} += C_d^T x_n,

with no gathers.  The per-offset channels ``C [n_off, N, t, t]`` are what
the whole-solve CG kernel (``ops/stencil_cg.py``) consumes.
"""

import numpy as np
import torch


def _coupling_flat(J, WJ):
    """C_e = J_i^T W J_j as flat [E, t*t] rows (row-major t x t)."""
    t = J.shape[-1]
    return torch.einsum('edt,edu->etu', WJ[:, :, 0, :],
                        J[:, :, 1, :]).reshape(-1, t * t)


class StencilSpMV:
    r"""Circulant-stencil SpMV: the gather-free form for banded graphs.

    Args:
        edges: int [E, 2] node index pairs (host array or tensor; the
            structure is static).
        n_nodes: number of nodes N.
        tan: tangent dim t (6 for SE3).
        max_offsets: refuse graphs needing more offset channels.
        device: device of the per-step channel tensors.

    Construction raises ``ValueError`` when the graph needs more than
    ``max_offsets`` channels, or when the channels would be mostly zeros
    (``n_off * N > 4 E``).  Duplicate (i, offset) edges sum into one
    channel slot.
    """

    def __init__(self, edges, n_nodes, tan, max_offsets=16, device=None):
        edges = edges.cpu().numpy() if torch.is_tensor(edges) \
            else np.asarray(edges)
        self.N = int(n_nodes)
        self.tan = int(tan)
        E = edges.shape[0]
        delta = (edges[:, 1] - edges[:, 0]) % self.N
        offsets = np.unique(delta)
        if len(offsets) > max_offsets:
            raise ValueError(f'{len(offsets)} distinct circular offsets '
                             f'> max_offsets={max_offsets}')
        if len(offsets) * self.N > 4 * max(E, 1):
            # stencil work is O(n_off * N) whatever E is, so sparse
            # channels lose to a coupling-block formulation
            raise ValueError('stencil channels too sparse '
                             f'({len(offsets)} offsets x {self.N} nodes '
                             f'for {E} edges)')
        self.offsets = [int(d) for d in offsets]
        # channel slot of edge e: (offset index, source node i)
        off_index = np.searchsorted(offsets, delta)
        self._slot = torch.as_tensor(off_index * self.N + edges[:, 0],
                                     dtype=torch.int64, device=device)
        self.E = E

    def precompute(self, J, WJ):
        """Channels ``C [n_off, N, t, t]`` from one factor's blocks."""
        return self.precompute_multi([(J, WJ)])

    def precompute_multi(self, pairs):
        """Channels from per-factor (J, WJ) weighted-block pairs whose
        concatenated edge order matches this object's construction order
        (how SparseLM merges all its factors into one stencil)."""
        t = self.tan
        C = torch.cat([_coupling_flat(J, WJ) for J, WJ in pairs], dim=0)
        chan = C.new_zeros((len(self.offsets) * self.N, t * t))
        # accumulate=True sums duplicate slots in a fixed order on the
        # card too (sort-based), where index_add_ would use atomics
        chan.index_put_((self._slot,), C, accumulate=True)
        return chan.reshape(len(self.offsets), self.N, t, t)

    def couple(self, C, x):
        """Off-diagonal part of ``A x`` via the offset stencils."""
        y = torch.zeros_like(x)
        for k, d in enumerate(self.offsets):
            xr = torch.roll(x, -d, dims=0)
            y = y + torch.einsum('ntu,nu->nt', C[k], xr)
            back = torch.einsum('ntu,nt->nu', C[k], x)
            y = y + torch.roll(back, d, dims=0)
        return y

    def matvec(self, C, D, x):
        """``A x`` with D [N, t, t] diagonal blocks."""
        return torch.einsum('ntu,nu->nt', D, x) + self.couple(C, x)
